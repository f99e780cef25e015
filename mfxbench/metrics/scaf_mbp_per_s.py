"""Input contig bases taken through findmitoscaf + annotate a second: every
base of every draft finished in the window over the window's whole time."""


def read(r):
    return r.bases / 1e6 / r.window_s if r.window_s > 0 and r.samples else None
