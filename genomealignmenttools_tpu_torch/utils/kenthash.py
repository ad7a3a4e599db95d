"""Kent-library hash table ordering emulation.

chainCleaner's output ordering (removedSuspects.bed line order, suspect
processing order, tie-breaks after the final sort) is determined by the
iteration order of kent hash tables (kent/src/lib/hash.c).  To reproduce
byte-identical outputs we model exactly:

- hashString (hash.c:41-53): result = result*9 + c over the bytes, uint32.
- hashNew(0): 2^12 buckets; mask = size-1.
- hashAdd prepends within a bucket (LIFO).
- auto-expansion: after an add, if elCount > size (expansionFactor 1.0),
  resize to digitsBaseTwo(size) bits, i.e. size doubles; resize re-inserts
  by old traversal order with prepends and then reverses every bucket list,
  so relative traversal order within a bucket is *preserved* across resizes.
- hashTraverseEls: buckets ascending, each bucket head->tail.
- hashElListHash: same walk but building the result with prepends, so the
  returned list is the exact *reverse* of hashTraverseEls order.
"""

from __future__ import annotations


def kent_hash_string(s: str) -> int:
    """hashString: uint32 result = result*9 + byte."""
    result = 0
    for b in s.encode():
        result = (result * 9 + b) & 0xFFFFFFFF
    return result


class KentHash:
    """Order-faithful kent hash (stores python values)."""

    def __init__(self, power_of_two_size: int = 0):
        if power_of_two_size == 0:
            power_of_two_size = 12
        self.power = power_of_two_size
        self.size = 1 << power_of_two_size
        self.mask = self.size - 1
        # buckets: list of lists; bucket[i] is head-first (LIFO order)
        self.table: list[list[tuple[str, object, int]]] = [[] for _ in range(self.size)]
        self.el_count = 0
        self.auto_expand = True

    def add(self, name: str, val: object) -> None:
        hv = kent_hash_string(name)
        self.table[hv & self.mask].insert(0, (name, val, hv))
        self.el_count += 1
        if self.auto_expand and self.el_count > self.size:
            self._resize(self.power + 1)

    def _resize(self, new_power: int) -> None:
        old_table = self.table
        self.power = new_power
        self.size = 1 << new_power
        self.mask = self.size - 1
        self.table = [[] for _ in range(self.size)]
        # old traversal order, prepending into new buckets
        for bucket in old_table:
            for entry in bucket:
                self.table[entry[2] & self.mask].insert(0, entry)
        # then reverse all bucket lists (hashReverseAllBucketLists)
        for b in self.table:
            b.reverse()

    def lookup(self, name: str):
        hv = kent_hash_string(name)
        for n, v, _ in self.table[hv & self.mask]:
            if n == name:
                return v
        return None

    def __contains__(self, name: str) -> bool:
        hv = kent_hash_string(name)
        return any(n == name for n, _, _ in self.table[hv & self.mask])

    def update(self, name: str, val: object) -> None:
        """Replace the value of an existing entry in place (no reorder)."""
        hv = kent_hash_string(name)
        bucket = self.table[hv & self.mask]
        for i, (n, _, h) in enumerate(bucket):
            if n == name:
                bucket[i] = (n, val, h)
                return
        raise KeyError(name)

    def remove(self, name: str) -> None:
        hv = kent_hash_string(name)
        bucket = self.table[hv & self.mask]
        for i, (n, _, _) in enumerate(bucket):
            if n == name:
                del bucket[i]
                self.el_count -= 1
                return
        raise KeyError(name)

    def traverse_order(self) -> list[tuple[str, object]]:
        """hashTraverseEls order: buckets ascending, head->tail."""
        out = []
        for bucket in self.table:
            for n, v, _ in bucket:
                out.append((n, v))
        return out

    def el_list_order(self) -> list[tuple[str, object]]:
        """hashElListHash order: reverse of traverse order."""
        return list(reversed(self.traverse_order()))


def kent_traverse_order(names: list[str]) -> list[str]:
    """Order in which hashTraverseEls would visit `names` if they were
    hashAdd-ed in the given order to a hashNew(0) table."""
    h = KentHash()
    for n in names:
        h.add(n, None)
    return [n for n, _ in h.traverse_order()]


def kent_el_list_order(names: list[str]) -> list[str]:
    """Order from hashElListHash for names added in the given order."""
    h = KentHash()
    for n in names:
        h.add(n, None)
    return [n for n, _ in h.el_list_order()]
