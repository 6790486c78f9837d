"""The row codec (``codec/rows.py``)."""
