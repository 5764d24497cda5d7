"""Host clock from the captured one-lane step's call to its telemetry on
the host, mean per frame of the window (the driver's own timing; the
profiler is off there)."""


def read(r):
    if not r.step_host_ms:
        return None
    return sum(r.step_host_ms) / len(r.step_host_ms)
