"""The serving engine: sampling, the KV page manager, the torch engine."""
