from .load_data import load_data, load_everything  # noqa: F401
