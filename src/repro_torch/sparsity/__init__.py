"""SGL structured sparsity of LM weight groups."""
