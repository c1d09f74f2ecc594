"""Training of the port: AdamW, int8 gradient compression, the train step."""
