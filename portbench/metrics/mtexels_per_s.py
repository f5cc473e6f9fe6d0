"""Source texels of every level and face of every texture completed in
the window, over the window's seconds, in millions."""


def read(run):
    return run.texels * len(run.done) / run.window.seconds / 1e6
