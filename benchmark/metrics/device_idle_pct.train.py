"""The card's idle share of the traced window of train steps (%): 100 x (1 -
the union of every device operation's interval over the window)."""


def read(trace):
    if not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
