"""OpenAI-compatible HTTP front end."""
