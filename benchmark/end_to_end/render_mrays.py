"""Primary rays (pixels x samples) of every frame finished in the window,
in millions, over the window's seconds (its first frame's start to the
end of the last frame started in it)."""


def read(window):
    if not window.units:
        return None
    return sum(window.rays) / window.seconds / 1e6
