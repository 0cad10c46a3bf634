"""Share of the window the trainer waited in the feed's ``next``
(``batch_iterator`` padding scenes into a batch on the card), host
clock, in %."""


def read(run):
    if run.data_wait_s is None or not run.window_s:
        return None
    return 100.0 * run.data_wait_s / run.window_s
