"""Cost model and group planner of the C step (``cost.py``)."""
