"""Device milliseconds a step of code2seq's path encoder (the program's edged
``path_encoder`` span inside ``forward``: the node lookups and both LSTMs'
forward), over the traced run's window."""


def read(run):
    row = (run.counters.get("program") or {}).get("path_encoder")
    if not row or not row["device_count"]:
        return None
    return row["device_ms"] / row["device_count"]
