"""Model zoo of the port (the dense GQA decoder so far)."""
