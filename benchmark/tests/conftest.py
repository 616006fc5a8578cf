"""The benchmark's own tests: run them from the repository's root with
``python -m pytest benchmark/tests``. Tests marked ``cuda`` need a card
and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
