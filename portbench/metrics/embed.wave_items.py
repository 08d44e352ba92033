"""embed.wave_items (items): items over waves that the service's batchers
ran in the traced window (DynamicBatcher.stats, both kinds)."""


def read(view, window, cell):
    waves = window.units.get("waves", 0)
    return window.units["wave_items"] / waves if waves else None
