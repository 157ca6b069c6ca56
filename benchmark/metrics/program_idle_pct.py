"""Percent of the traced window in which the card was idle while the
host was inside one of the program's spans (``bolt.<span>`` ranges);
the rest of ``device_idle_pct`` is the harness between and around
passes.  None where the program opens no span in the window."""

from benchmark import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or s.window_s <= 0 or not any(
            n for n, _, _ in s.table.values()):
        return None
    return 100.0 * s.program_idle_s / s.window_s
