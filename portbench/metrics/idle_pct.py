"""The device's idle share: the part of the traced window in which no
kernel, copy or set ran on the card (the union of their intervals from
the profiler's trace), in %."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
