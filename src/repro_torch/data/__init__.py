"""Data helpers of the port: the byte tokenizer."""
