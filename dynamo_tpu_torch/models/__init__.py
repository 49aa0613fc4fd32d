"""Model configs, the decoder (dense GQA, or DeepSeek MLA with MoE FFNs)
and its weights."""
