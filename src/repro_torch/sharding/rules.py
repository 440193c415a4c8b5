"""The row-window layout of a placed synthesis wave, from the JAX
package's ``sharding/rules.py``.

A mesh's ``model`` axis is tensor-parallel and every other axis but a
serving mesh's ``hosts`` is batch-parallel (``MeshAxes``).  A spec names,
per dimension of an operand, the mesh axes that dimension is split over,
or None where it is whole: the reference's ``PartitionSpec``, kept here as
a plain tuple.

The placed path needs one rule, ``wave_window_specs``: a host window's
row operands (its conditioning rows, row keys, classifier ids and labels,
and the x / ε / noise rows) split by rows over the host submesh's data
axes, while the wave-resident scalar table, the guidance vector and the
mode vector are replicated, read through the cfg kernel's ``row_offset``.
The ``model`` axis does no window work: the DiT's weights replicate and a
window's rows do not depend on each other, so a window chunk runs once,
on the first device of its model group (``launch/mesh.py::
data_devices``).

The reference's ``param_specs``, ``batch_specs`` and ``cache_specs`` lay
out the LM zoo's parameters, batches and caches; they come with the LM
training slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshAxes:
    data: tuple            # ("pod", "data") or ("data",)
    model: str             # "model"

    @property
    def all_data(self):
        return self.data if len(self.data) > 1 else self.data[0]


def wave_window_specs(ax: MeshAxes) -> dict:
    """Specs for one host window of a placed synthesis wave: the window's
    image-shaped tensors (x / ε / noise, batch-leading 4-D), its
    conditioning rows, row keys, classifier ids and labels split their
    rows over the host's data axes (a window is rounded to the data size,
    so the split is even); the wave-resident (·, B_wave) scalar table, the
    wave-wide guidance and mode vectors are replicated."""
    D = ax.all_data
    return {
        "window": (D, None, None, None),    # x / eps_c / eps_u / noise
        "cond": (D, None),                  # window conditioning rows
        "row_keys": (D,),                   # per-row noise keys
        "scalar_table": (None, None),       # wave-resident (·, B_wave)
        "guidance": (None,),                # wave-wide (B_wave,)
        "mode": (None,),                    # wave-wide (B_wave,) modes
        "clf_ids": (D,),                    # window-local classifier slots
        "labels": (D,),                     # window-local classifier targets
    }


def splits_rows(spec: tuple) -> bool:
    """Whether an operand of this spec is split by rows (its first
    dimension names mesh axes) rather than replicated."""
    return bool(spec) and spec[0] is not None
