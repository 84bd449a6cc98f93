"""Checkpoints of LM train states, in the reference's on-disk layout."""
