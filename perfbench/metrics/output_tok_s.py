"""Every output token the host received in the window over the window's
length."""

from perfbench.readers import tokens_in_window


def read(run):
    return tokens_in_window(run) / run.seconds
