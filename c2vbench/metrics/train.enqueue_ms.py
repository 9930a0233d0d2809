"""Host milliseconds a step spends in ``EpochRunner.train_chunk`` (the
device-epoch feed enqueuing its chunk), over the window's untraced steps."""


def read(run):
    c = run.counters
    if not c.get("enqueue_steps"):
        return None
    return 1e3 * c["enqueue_s"] / c["enqueue_steps"]
