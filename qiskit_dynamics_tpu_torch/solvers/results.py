"""Results container for ODE/LMDE solves (scipy OdeResult-compatible)."""
from __future__ import annotations


class OdeResult(dict):
    """Attribute-accessible dict mirroring ``scipy.integrate`` result objects.

    Fields: ``t`` (times), ``y`` (states, leading axis = time), plus any
    solver statistics (``nfev``, ``naccept``, ...).
    """

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name, value):
        self[name] = value

    def __repr__(self):
        if self.keys():
            m = max(map(len, list(self.keys()))) + 1
            return "\n".join([k.rjust(m) + ": " + repr(v) for k, v in sorted(self.items())])
        return self.__class__.__name__ + "()"
