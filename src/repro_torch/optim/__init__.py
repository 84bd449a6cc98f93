"""The LM optimizer: AdamW and its schedule."""
