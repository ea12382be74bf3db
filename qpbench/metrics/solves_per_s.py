"""Lanes reported converged in the window, over the window's seconds."""


def read(rec):
    return rec.window.converged / rec.window.window_s
