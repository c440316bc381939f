"""LLM serving layer: protocols, tokenizer, preprocessor, backend, HTTP."""
