"""The copy_ms_per_request metric (ms).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """Device time of the host-to-device and device-to-host copies in the
    trace over the traced requests."""
    tr = ctx["trace"]
    if not tr:
        return None
    ns = sum(e - s for name, s, e, _ in tr["events"] if name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name))
    return ns / 1e6 / tr["requests"] if ns else None
