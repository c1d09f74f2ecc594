"""The plain reference of the benchmark: a dense GQA decoder and the MoE in
plain PyTorch, with AdamW. It imports nothing of the program and takes
only the weights and inputs the benchmark made."""
