"""ANSI color text (a copy of ``minizero_tpu/utils/color_message.py``;
reference ``utils/color_message.h``).

The reference colors its console board displays (go.cpp:329-344 paints
stones bold black/white on a yellow board). GTP replies must stay
machine-parseable, so color applies only when enabled by
``program_use_color_message`` AND stdout is an interactive terminal.
"""

from __future__ import annotations

import sys

_COLORS = {
    "black": 30, "red": 31, "green": 32, "yellow": 33,
    "blue": 34, "purple": 35, "cyan": 36, "white": 37,
}


def color_enabled(cfg=None) -> bool:
    use = True if cfg is None else bool(getattr(cfg, "program_use_color_message", True))
    try:
        return use and sys.stdout.isatty()
    except Exception:
        return False


def get_color_text(text: str, bold: bool = False, color: str = "",
                   background: str = "") -> str:
    """reference utils/color_message.h getColorText."""
    codes = []
    if bold:
        codes.append("1")
    if color in _COLORS:
        codes.append(str(_COLORS[color]))
    if background in _COLORS:
        codes.append(str(_COLORS[background] + 10))
    if not codes:
        return text
    return f"\033[{';'.join(codes)}m{text}\033[0m"
