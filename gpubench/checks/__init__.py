"""CPU checks of the benchmark, run by explicit path (their names are not
collected by a bare `pytest`):

    python -m pytest -q gpubench/checks/check_*.py
"""
