"""Requests a device call (``serve/batcher.py``): each answer's
``ServeResult.coalesced``, weighted to calls (requests over the calls they
rode in)."""


def read(run):
    co = [c for c in run.counters.get("coalesced", ()) if c > 0]
    if not co:
        return None
    return len(co) / sum(1.0 / c for c in co)
