"""Output tokens emitted in the window over the window's seconds (host
clock)."""


def read(run):
    return len(run.tokens_in_window()) / run.window_end
