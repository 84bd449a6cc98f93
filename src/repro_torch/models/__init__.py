"""The dense decoder family of the LM zoo."""
