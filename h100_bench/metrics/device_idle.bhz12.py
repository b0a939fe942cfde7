"""device_idle: percent of the traced window in which no operation runs
on the card (1 - union of device intervals / window)."""
from readers import device_idle


def read(run):
    return device_idle(run)
