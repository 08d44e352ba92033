"""embed.copy_ms (ms): device milliseconds of host-to-device copies a wave
in the traced window (the engine's batch .to(device))."""


def read(view, window, cell):
    waves, seconds = window.units.get("waves", 0), view.copy_seconds("HtoD")
    return 1e3 * seconds / waves if waves and seconds > 0 else None
