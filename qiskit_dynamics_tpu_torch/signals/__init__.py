"""Signals: time-dependent model coefficients."""
from .signals import Signal, SignalCollection, SignalSum, SignalList, to_SignalSum
