"""The device's idle share of the traced repeat: the time between the
benchmark's marks in which no device activity (kernel, copy or fill) ran,
over the marks' span."""

from gpubench.trace import idle_percent


def read(rec):
    return idle_percent(rec["trace"])
