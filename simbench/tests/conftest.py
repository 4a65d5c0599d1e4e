import sys
from pathlib import Path

# the program, for the tests that hold the frozen yardsticks to it
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
