"""The window's milliseconds over the steps finished in it, each step
timed to the synchronize after it."""


def read(window):
    if not window.units:
        return None
    return window.seconds / window.units * 1e3
