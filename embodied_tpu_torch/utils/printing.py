"""Colored, flushed printing helpers (elements.print equivalent).

A copy of embodied_tpu/utils/printing.py.
"""

import sys

_COLORS = {
    'black': 30, 'red': 31, 'green': 32, 'yellow': 33,
    'blue': 34, 'magenta': 35, 'cyan': 36, 'white': 37,
}


def print_(*args, color=None, flush=True):
  text = ' '.join(str(x) for x in args)
  if color and sys.stdout.isatty():
    code = _COLORS.get(color, 37)
    text = f'\033[{code}m{text}\033[0m'
  print(text, flush=flush)
