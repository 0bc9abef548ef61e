"""A "directory" mix: `BatchedFile2File.process_many` called once over
every file of a pass of the library, as the CLI's directory mode calls it
once over every file it claimed.

The library, its groups, the weights, the warm-up, the callbacks and the
comparison are a library mix's (`harness/library.py`). One unit of the
window is one call: the library's fixed groups in the order the seed draws
for that pass, concatenated. `process_many` cuts the list into groups of
`group_files` files again, so it forms the same groups and forwards only
the shapes set-up warmed, and whatever the program overlaps across the
groups of one call shows in the window."""

from __future__ import annotations

from harness.library import Library


class Directory(Library):
    def unit(self) -> float:
        """One `process_many` call over a whole pass: the groups in this
        pass's seeded order (a short group, if the library has one, last,
        where `process_many` forms it again), file after file."""
        order = self.order_rng.permutation(len(self.groups))
        short = lambda j: len(self.groups[j]) < self.traffic["group_files"]
        files = [i for j in sorted(order, key=short) for i in self.groups[j]]
        if self.spans is None:
            return self._group(files)
        with self.spans.span("call"):
            return self._group(files)
