"""Traffic drivers (``<driver>.py``) and the mixes that name them
(``<mix>.json``)."""
