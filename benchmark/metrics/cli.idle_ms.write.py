"""The card's idle milliseconds per command-line run while the command
line tonemaps the frame and writes its PPM (``rtow.cli.write``).  Read
from the program's spans (``benchmark/spans.py``); a program without the
command line's spans reads None."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, "rtow.cli.run", "rtow.cli.write")
