"""Input read bases taken through `all` a second: every base of every
sample finished in the window over the window's whole time."""


def read(r):
    return r.bases / 1e6 / r.window_s if r.window_s > 0 and r.samples else None
