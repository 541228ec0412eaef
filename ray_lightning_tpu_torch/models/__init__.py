"""Model families ported so far: GPT (models/gpt.py)."""
