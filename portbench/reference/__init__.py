"""The plain reference that decides `correct` (see render.py)."""
