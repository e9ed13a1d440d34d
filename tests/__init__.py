"""The test suite, a regular package so that ``tests.*`` imports (e.g. from
chip_smoke.py) resolve here before any other installed ``tests`` package."""
