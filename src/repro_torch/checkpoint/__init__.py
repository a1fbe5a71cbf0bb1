"""Atomic, versioned checkpoints: fitted GP sessions and train-loop state.

Counterpart of ``repro/checkpoint``, on the same on-disk format, so the
two packages load each other's checkpoints:

* :mod:`.store`: nested dicts of tensors written as path-keyed npz
  (bfloat16 as a uint16 view, with a dtype manifest) into
  ``<dir>/tmp.<step>.<pid>``, then ``os.replace``-d to ``step_<n>``;
* :class:`.store.AsyncCheckpointer`: the train loop's writes, overlapped
  with the next steps;
* :mod:`.gpstate`: ``GP.save``/``GP.load`` on top, with the spec's
  structure and an omega hash in the manifest.
"""
from .gpstate import latest_version, load_state, save_state
from .store import AsyncCheckpointer, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer", "save_state",
           "load_state", "latest_version"]
