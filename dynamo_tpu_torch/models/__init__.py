"""Model configs, the dense GQA decoder and its weights."""
