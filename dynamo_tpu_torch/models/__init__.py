"""Model configuration, the dense Llama forward and the params bridge."""
