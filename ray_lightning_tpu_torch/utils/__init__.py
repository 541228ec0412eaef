"""Host-side utilities: seeding (utils/seed.py), state streams
(utils/states.py), the CSV metrics logger (utils/logger.py) and the
optional-dependency guards (utils/imports.py)."""
