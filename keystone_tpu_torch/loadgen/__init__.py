"""Load generation and chaos: the fault-injection plane (``faults.py``)."""
