"""Seconds from the process's start to the first timed step: imports,
generation, kernel load, the engine's build and the warm-up."""


def read(run):
    return run.setup_s
