"""The share of the path LSTMs' node steps that read a real node of a real
context (``path_steps_real`` over ``path_steps_run``, the program's
``path_encoder`` span): the rest is PAD work."""


def read(run):
    row = (run.counters.get("program") or {}).get("path_encoder")
    if not row:
        return None
    real, ran = row["args"].get("path_steps_real"), row["args"].get("path_steps_run")
    if not ran or real is None:
        return None
    return 100.0 * real / ran
