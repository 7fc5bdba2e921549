"""Work counts: the operations and bytes an algorithm needs for one call,
from the cell's shapes alone, and the least time the card needs for them.

Counted so whatever kernels implement the algorithm: each input byte read
once and each output byte written once; intermediates of one implementation
(the polynomial engine's step matrices) are not counted. A traffic mix names
its count under ``"work"``: the module ``portbench/counts/<work>.py``, whose
``work(shape)`` returns ``(flops, bytes)``.
"""
