"""Operations and bytes of each configuration's step and call, counted
from the shapes by formulas the benchmark owns (``formulas.py``), one
module a configuration (``<config>.py``).  Nothing here reads a count from
the measured program."""
