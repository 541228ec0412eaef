"""Host-side utilities: seeding (utils/seed.py)."""
