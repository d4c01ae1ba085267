"""The card's idle milliseconds per command-line run while the command
line builds its scene (``rtow.cli.scene``: ``scene_for_config``, the
cover's spheres drawn on the host and copied to the card).  Read from the
program's spans (``benchmark/spans.py``); a program without the command
line's spans reads None."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, "rtow.cli.run", "rtow.cli.scene")
