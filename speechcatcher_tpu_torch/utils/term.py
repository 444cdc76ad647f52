"""Terminal live-output helpers: ANSI multi-line partial renderer (port of
``speechcatcher_tpu/utils/term.py``).

Partial transcripts re-render over themselves as they grow, wrapping at
~100 columns on token-friendly boundaries.
"""

from __future__ import annotations

import sys

WRAP_COLUMNS = 100


def delete_multiple_lines(n: int = 1):
    """Delete the last n terminal lines and reset the cursor."""
    for _ in range(n):
        sys.stdout.write("\x1b[2K")  # erase the line
        sys.stdout.write("\x1b[1A")  # cursor up
    sys.stdout.write("\n\r")


def progress_output(text: str, prev_lines: int = 0) -> int:
    """Render `text` in place of the previous render; returns the number of
    lines written (pass back as prev_lines next call). Wraps after
    WRAP_COLUMNS at whitespace/sentence boundaries."""
    lines = [""]
    last_ch = ""
    for ch in text:
        if len(lines[-1]) > WRAP_COLUMNS and last_ch in (" ", ".", "?", "!"):
            lines.append("")
        lines[-1] += ch
        last_ch = ch

    delete_multiple_lines(n=prev_lines)
    sys.stdout.write("\n".join(lines))
    sys.stdout.flush()
    return len(lines)
