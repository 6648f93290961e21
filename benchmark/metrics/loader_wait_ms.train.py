"""Host milliseconds a step waited for its batch from the program's
``DataLoader`` (``datasets/loader.py``), timed by the window's loop."""


def read(reading):
    waits = reading.window.get("loop", {}).get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
