"""Host-side utilities: seeding (utils/seed.py), state streams
(utils/states.py) and the CSV metrics logger (utils/logger.py)."""
