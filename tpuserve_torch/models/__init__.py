"""Model configs, tokenizer, weights and the transformer."""
