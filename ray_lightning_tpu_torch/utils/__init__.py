"""Host-side utilities: seeding (utils/seed.py), state streams
(utils/states.py), the CSV metrics logger (utils/logger.py), the
optional-dependency guards (utils/imports.py) and the throughput and
profiler callbacks (utils/profiling.py)."""
