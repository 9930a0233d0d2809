"""Device milliseconds a step of code2seq's decoder (the program's edged
``decoder`` span inside ``forward``: the attention decoder's steps, the
head and the loss), over the traced run's window."""


def read(run):
    row = (run.counters.get("program") or {}).get("decoder")
    if not row or not row["device_count"]:
        return None
    return row["device_ms"] / row["device_count"]
