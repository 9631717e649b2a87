"""From the start of ``run.py`` to the window's start: imports, the build
where it is not yet there, the configuration's own set-up, the pool of
statements and one proof of the cell's shape."""


def read(run):
    return run.setup_s
