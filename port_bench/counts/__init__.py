"""The benchmark's frozen yardstick: peaks, the operations and bytes a tile
compositor's work needs (`tiles.py`), and the whole step's operations
(`step.py`)."""
