"""Solver argument helpers (counterpart of the list-broadcasting helper of
``qiskit_dynamics_tpu/solvers/solver_utils.py``; the rest of that module is
still to be ported, see ``ROADMAP.md``)."""
from __future__ import annotations

from typing import Callable, List, Tuple

from ..exceptions import DynamicsError

__all__ = ["setup_args_lists"]


def setup_args_lists(
    args_list: List, args_names: List[str], args_to_list: List[Callable]
) -> Tuple[List[List], bool]:
    """Broadcast a group of possibly-listed args to lists of equal length."""
    args_as_lists = []
    args_were_lists = False
    for arg, to_list in zip(args_list, args_to_list):
        arg_as_list, arg_was_list = to_list(arg)
        args_as_lists.append(arg_as_list)
        args_were_lists = args_were_lists or arg_was_list

    arg_lens = [len(x) for x in args_as_lists]
    max_len = max(arg_lens)
    for idx, arg_len in enumerate(arg_lens):
        if arg_len not in (1, max_len):
            max_name = args_names[arg_lens.index(max_len)]
            names = ", ".join(args_names[:-1]) + f", and {args_names[-1]}"
            raise DynamicsError(
                f"If one of {names} is given as a list of valid inputs, then the others must "
                f"specify only a single input, or a list of the same length. {max_name} "
                f"specifies {max_len} inputs, but {args_names[idx]} is of length {arg_len}, "
                "which is incompatible."
            )

    args_as_lists = [
        x * max_len if arg_len == 1 else x for x, arg_len in zip(args_as_lists, arg_lens)
    ]
    return args_as_lists, args_were_lists
