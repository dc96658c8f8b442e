"""Legion topology — the paper's hierarchical communicator organization (§V),
generalized from the fixed {flat, 2-level} pair to a recursive N-level tree.

The target communicator (our cluster of nodes) is split into disjoint
``local_comm``s (*legions*) of max size ``k``: node with rank ``r`` belongs to
legion ``r // k`` — the assignment is final (paper: "The assignment of a
process to a local_comm is final"). Above level 0 the structure recurses:
the masters of every ``k`` adjacent legions form a *super-legion* at level 1,
the masters of every ``k`` super-legions form a level-2 group, and so on,
until a single root comm closes the tree at level ``depth - 1``. Each
non-root level has a POV (Partially-OVerlapped) ring: group *i*'s POV is its
members plus the master of its *successor* group at the same level, used
exclusively during repair (paper Fig. 2, applied per level). ``depth == 2``
is exactly the paper's layout (legions + one global_comm of masters);
``depth == 1`` is the degenerate flat mode.

Grouping above level 0 is derived from the *final* legion indices
(legion ``i`` lives under level-ℓ group ``i // k**ℓ``), so the paper's
assignment-finality extends to every level: repairs never migrate a subtree.

Properties the paper claims — each is asserted by property tests, now at
every depth:
  (a) #communicators scales linearly with #nodes;
  (b) every node can reach any other (directly or via its master chain);
  (c) there is exactly one master-path between any two nodes.

Scoped repair (Rocco & Palermo 2022): a fault only forces the repair of the
communicators that actually contain it — :meth:`LegionTopology.fault_groups`
computes that minimal set by climbing the failed node's mastership chain,
and :meth:`LegionTopology.partition_scopes` folds an agreed verdict into
disjoint :class:`~repro_torch.core.types.RepairScope`\\ s whose repairs can proceed
concurrently (disjoint participant sets — healthy subtrees never enter the
repair path).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Iterator

import numpy as np

from repro_torch.core.policy import LegioPolicy
from repro_torch.core.types import RepairScope


class TopologyTornError(RuntimeError):
    """Raised when a repair tries to mutate the topology while a
    :class:`TopologyView` is pinned — the invariant ULFM gets for free from
    ``MPIX_Comm_shrink``'s collectivity (every participant enters the repair,
    so no collective can be mid-flight on the old structure)."""


class StaleLegionError(KeyError):
    """A group index that no longer names a live group at its level —
    typically a legion that emptied and left the ring. Raised by
    ``successor``/``predecessor``/``pov`` (and their ``*_at`` generalizations)
    instead of leaking a bare ``StopIteration`` from an internal search."""


@dataclass
class Legion:
    """One local_comm: members are global node ids, sorted ascending."""
    index: int
    members: list[int]

    @property
    def master(self) -> int:
        """Paper: the master is the process with the lowest rank."""
        return min(self.members)

    def __len__(self) -> int:
        return len(self.members)


@dataclass(frozen=True)
class LevelGroup:
    """One communicator of the recursive hierarchy at ``level``.

    At level 0 this is a live legion viewed as a group (members are node
    ids, no children). At level ℓ ≥ 1 the members are the masters of the
    child groups at level ℓ-1 and ``children`` carries those groups'
    indices. The top level (``depth - 1``) is a single root group — the
    generalization of the paper's global_comm.
    """

    level: int
    index: int
    members: tuple[int, ...]
    children: tuple[int, ...] = ()

    @property
    def master(self) -> int:
        """Lowest rank of the subtree (min of mins) — the paper's rule."""
        return min(self.members)

    def __len__(self) -> int:
        return len(self.members)


@dataclass
class LegionTopology:
    """The full hierarchical communicator structure over live nodes."""

    k: int                          # max legion size (paper knob)
    legions: list[Legion]
    # original (pre-fault) legion index per node — assignment is final
    home: dict[int, int] = field(default_factory=dict)
    # epoch counter: bumped by every structural mutation; collectives snapshot
    # the structure behind an epoch-stamped TopologyView and pin it, so a
    # mid-pipeline repair can never tear a structure a collective is reading
    epoch: int = 0
    # number of levels including the root comm: 1 = flat, 2 = the paper's
    # legions + global_comm, d >= 3 adds super-legion levels in between
    depth: int = 2
    _pins: int = field(default=0, init=False, repr=False)
    # member -> Legion index kept coherent across every mutation: legion_of
    # is on the serve router's and collectives' hot path (O(1), not a scan)
    _by_member: dict[int, Legion] = field(
        default_factory=dict, init=False, repr=False, compare=False)
    _levels_cache: list[list[LevelGroup]] = field(
        default_factory=list, init=False, repr=False, compare=False)
    _levels_epoch: int = field(default=-1, init=False, repr=False,
                               compare=False)
    # scoped-repair index tables (ring order, parent pointers, numpy member
    # arrays), rebuilt lazily per epoch — see _scope_tables
    _scope_cache: list[dict] = field(
        default_factory=list, init=False, repr=False, compare=False)
    _scope_epoch: int = field(default=-1, init=False, repr=False,
                              compare=False)

    def __post_init__(self) -> None:
        self._reindex()

    def _reindex(self) -> None:
        self._by_member = {n: lg for lg in self.legions for n in lg.members}

    # ---- construction ----------------------------------------------------

    @staticmethod
    def build(nodes: list[int], k: int, depth: int = 2) -> "LegionTopology":
        nodes = sorted(nodes)
        if k <= 0:
            raise ValueError(f"legion size k must be positive, got {k}")
        if depth < 1:
            raise ValueError(f"hierarchy depth must be >= 1, got {depth}")
        if depth == 1:
            return LegionTopology.flat(nodes)
        legions = [
            Legion(index=i, members=nodes[i * k:(i + 1) * k])
            for i in range((len(nodes) + k - 1) // k)
        ]
        home = {n: i for i, lg in enumerate(legions) for n in lg.members}
        return LegionTopology(k=k, legions=legions, home=home, depth=depth)

    @staticmethod
    def flat(nodes: list[int]) -> "LegionTopology":
        """Degenerate single-legion topology (the non-hierarchical mode)."""
        nodes = sorted(nodes)
        lg = Legion(index=0, members=list(nodes))
        return LegionTopology(k=max(len(nodes), 1), legions=[lg],
                              home={n: 0 for n in nodes}, depth=1)

    # ---- views -------------------------------------------------------------

    @property
    def nodes(self) -> list[int]:
        return sorted(n for lg in self.legions for n in lg.members)

    @property
    def size(self) -> int:
        return sum(len(lg) for lg in self.legions)

    @property
    def n_legions(self) -> int:
        return len(self.legions)

    @property
    def masters(self) -> list[int]:
        """The level-1 comm membership (one master per live legion)."""
        return [lg.master for lg in self.legions if lg.members]

    def legion_of(self, node: int) -> Legion:
        try:
            return self._by_member[node]
        except KeyError:
            raise KeyError(f"node {node} not in topology") from None

    def is_master(self, node: int) -> bool:
        lg = self._by_member.get(node)
        return lg is not None and lg.master == node

    # ---- recursive levels ----------------------------------------------------

    def levels(self) -> list[list[LevelGroup]]:
        """Live groups at levels ``1 .. depth-1`` (index 0 of the returned
        list is level 1; the last entry is the single-group root comm).
        Derived from the level-0 structure on demand and cached per epoch,
        so mutations only ever touch the legions and the derivation can
        never drift out of sync."""
        if self._levels_epoch == self.epoch:
            return self._levels_cache
        out: list[list[LevelGroup]] = []
        child_index = [lg.index for lg in self.legions if lg.members]
        child_master = {lg.index: lg.master
                        for lg in self.legions if lg.members}
        for level in range(1, self.depth):
            buckets: dict[int, list[int]] = {}
            if level == self.depth - 1:
                # root comm: one group over every surviving child master
                buckets[0] = list(child_index)
            else:
                for ci in child_index:
                    buckets.setdefault(ci // self.k, []).append(ci)
            groups = [
                LevelGroup(
                    level=level, index=gi,
                    members=tuple(sorted(child_master[ci] for ci in children)),
                    children=tuple(sorted(children)))
                for gi, children in sorted(buckets.items())
            ]
            out.append(groups)
            child_index = [g.index for g in groups]
            child_master = {g.index: g.master for g in groups}
        self._levels_cache, self._levels_epoch = out, self.epoch
        return out

    def groups(self, level: int) -> list[LevelGroup]:
        """Live groups at ``level`` (0 = legions wrapped as groups)."""
        if level == 0:
            return [LevelGroup(level=0, index=lg.index,
                               members=tuple(lg.members))
                    for lg in self.legions if lg.members]
        lv = self.levels()
        if not 1 <= level <= len(lv):
            raise StaleLegionError(
                f"level {level} does not exist (depth {self.depth})")
        return lv[level - 1]

    def group_at(self, level: int, index: int) -> LevelGroup:
        for g in self.groups(level):
            if g.index == index:
                return g
        raise StaleLegionError(
            f"no live group {index} at level {level} "
            f"(depth {self.depth}, epoch {self.epoch})")

    def parent_of(self, level: int, index: int) -> LevelGroup:
        """The level+1 group containing group ``index`` of ``level``."""
        for g in self.groups(level + 1):
            if index in g.children:
                return g
        raise StaleLegionError(
            f"group {index} at level {level} has no parent "
            f"(depth {self.depth}, epoch {self.epoch})")

    def master_chain(self, node: int) -> list[int]:
        """The node's masters at levels 0..depth-1 (legion master first,
        root master last) — the unique relay chain of property (b)."""
        lg = self.legion_of(node)
        chain, idx = [lg.master], lg.index
        for groups in self.levels():
            g = next((g for g in groups if idx in g.children), None)
            if g is None:
                raise StaleLegionError(
                    f"group {idx} lost its parent (epoch {self.epoch})")
            chain.append(g.master)
            idx = g.index
        return chain

    def subtree_of(self, legion_index: int) -> int:
        """Index of the top-level subtree (child group of the root comm)
        containing the legion — what the serve router shards over. For
        depth <= 2 every legion hangs off the root directly."""
        if self.depth <= 2:
            return legion_index
        idx = legion_index
        for groups in self.levels()[:-1]:       # exclude the root comm
            g = next((g for g in groups if idx in g.children), None)
            if g is None:
                raise StaleLegionError(
                    f"legion {legion_index} not under any live subtree "
                    f"(epoch {self.epoch})")
            idx = g.index
        return idx

    # ---- per-level POV rings --------------------------------------------------

    def comm_name(self, level: int, index: int) -> str:
        """Canonical name of a group comm — the single source for the
        strings repair steps and collective stages are keyed on
        (``local_i`` / ``l{level}_{i}`` / ``global`` for the root)."""
        if level == 0:
            return f"local_{index}"
        if level == self.depth - 1:
            return "global"
        return f"l{level}_{index}"

    def pov_name(self, level: int, index: int) -> str:
        """Canonical name of a POV comm (``pov_i`` / ``l{level}_pov_{i}``)."""
        return f"pov_{index}" if level == 0 else f"l{level}_pov_{index}"

    def successor_at(self, level: int, index: int) -> LevelGroup:
        order = self.groups(level)
        for i, g in enumerate(order):
            if g.index == index:
                return order[(i + 1) % len(order)]
        raise StaleLegionError(
            f"group {index} at level {level} is not in the ring "
            f"(emptied or never existed; epoch {self.epoch})")

    def predecessor_at(self, level: int, index: int) -> LevelGroup:
        order = self.groups(level)
        for i, g in enumerate(order):
            if g.index == index:
                return order[(i - 1) % len(order)]
        raise StaleLegionError(
            f"group {index} at level {level} is not in the ring "
            f"(emptied or never existed; epoch {self.epoch})")

    def pov_at(self, level: int, index: int) -> list[int]:
        """POV of group ``index`` at ``level``: its members plus the master
        of the successor group at the same level (paper Fig. 2, per level)."""
        g = self.group_at(level, index)
        members = list(g.members)
        succ = self.successor_at(level, index)
        if succ.index != index and succ.members:
            members.append(succ.master)
        return sorted(members)

    def successor(self, legion_index: int) -> Legion:
        order = [lg for lg in self.legions if lg.members]
        for i, lg in enumerate(order):
            if lg.index == legion_index:
                return order[(i + 1) % len(order)]
        raise StaleLegionError(
            f"legion {legion_index} is not in the ring "
            f"(emptied or never existed; epoch {self.epoch})")

    def predecessor(self, legion_index: int) -> Legion:
        order = [lg for lg in self.legions if lg.members]
        for i, lg in enumerate(order):
            if lg.index == legion_index:
                return order[(i - 1) % len(order)]
        raise StaleLegionError(
            f"legion {legion_index} is not in the ring "
            f"(emptied or never existed; epoch {self.epoch})")

    def pov(self, legion_index: int) -> list[int]:
        """POV_i = members of legion i + master of the successor (paper Fig. 2)."""
        return self.pov_at(0, legion_index)

    def povs(self) -> dict[int, list[int]]:
        return {lg.index: self.pov(lg.index) for lg in self.legions if lg.members}

    def buddy_of(self, node: int) -> int | None:
        """Replica buddy of ``node`` on the level-0 POV ring.

        ``pov()`` already links every legion to the master of its successor;
        the replica ring generalises that one edge to all members: the j-th
        member of a legion is paired with the ``j mod |succ|``-th member of
        the successor legion. Members are sorted ascending and the master is
        the minimum, so the master's buddy is exactly the successor master
        the POV comm names. Returns ``None`` when no out-of-legion buddy
        exists (single surviving legion) — a whole-legion loss then has no
        surviving replica holder and restores fall back to the store.
        """
        lg = self.legion_of(node)
        succ = self.successor(lg.index)
        if succ.index == lg.index or not succ.members:
            return None
        pos = lg.members.index(node)
        return succ.members[pos % len(succ.members)]

    def n_communicators(self) -> int:
        """world + per-group comm + per-group POV at every ring level + the
        root comm. Every level has at most ceil(n / k^(level+1)) groups, so
        the total stays linear in the number of nodes (paper property (a))."""
        total = 2                               # world + root comm
        for level in range(max(self.depth - 1, 1)):
            total += 2 * len(self.groups(level))
        return total

    def path(self, src: int, dst: int) -> list[int]:
        """The unique minimal master-relay path (paper property (b)/(c)):
        climb src's master chain to the lowest level whose group contains
        both endpoints, hop across that comm, descend dst's chain. For
        depth 2 this is exactly src -> master(src) -> master(dst) -> dst,
        collapsing duplicates."""
        ls, ld = self.legion_of(src), self.legion_of(dst)
        hops = [src]
        if ls.index == ld.index:
            if dst != src:
                hops.append(dst)
            return hops
        # group-index chains at levels 0..depth-1 (root shared by construction)
        gs, gd = [ls.index], [ld.index]
        for groups in self.levels():
            gs.append(next(g.index for g in groups if gs[-1] in g.children))
            gd.append(next(g.index for g in groups if gd[-1] in g.children))
        meet = next(i for i in range(len(gs)) if gs[i] == gd[i])
        chain_s, chain_d = self.master_chain(src), self.master_chain(dst)
        for nxt in chain_s[:meet] + list(reversed(chain_d[:meet])) + [dst]:
            if hops[-1] != nxt:
                hops.append(nxt)
        return hops

    # ---- scoped repair (Rocco & Palermo: confine repair to the fault) --------

    def _scope_tables(self) -> list[dict]:
        """Per-epoch index tables for the scoped-repair hot path: ring
        order, position, parent pointers, masters, and numpy member arrays
        per ``(level, group)``. Campaign-scale injection (10^4 chaos
        campaigns) made the per-call O(n) scans in ``fault_groups`` /
        ``partition_scopes`` dominate; one O(n) build per topology epoch
        amortizes every later lookup to O(1)."""
        if self._scope_epoch == self.epoch:
            return self._scope_cache
        per_level = [self.groups(0)] + self.levels()
        tables: list[dict] = []
        for lvl_groups in per_level:
            order = [g.index for g in lvl_groups]
            tables.append({
                "order": order,
                "pos": {gi: i for i, gi in enumerate(order)},
                # members are kept sorted by every mutator, so [0] is the
                # master (lowest rank) without a min() scan
                "members": {g.index: np.asarray(g.members, dtype=np.int64)
                            for g in lvl_groups},
                "master": {g.index: g.members[0]
                           for g in lvl_groups if g.members},
                "parent": {},
            })
        for lvl, lvl_groups in enumerate(per_level[1:], start=1):
            for g in lvl_groups:
                for ci in g.children:
                    tables[lvl - 1]["parent"][ci] = g.index
        self._scope_cache, self._scope_epoch = tables, self.epoch
        return tables

    def fault_groups(self, node: int) -> set[tuple[int, int]]:
        """The minimal set of ``(level, group index)`` comms whose repair the
        failure of ``node`` forces. A worker fault touches only its legion;
        a master fault adds the level-0 ring neighbours' POVs and the parent
        comm, and keeps climbing exactly as long as the dead node also held
        the mastership of the group above.

        O(depth) per call against the per-epoch :meth:`_scope_tables`
        (``_fault_groups_reference`` is the retained O(n) original the
        property tests diff against)."""
        lg = self.legion_of(node)
        touched = {(0, lg.index)}
        if self.depth <= 1:
            return touched
        tables = self._scope_tables()
        if len(tables[0]["order"]) <= 1:
            return touched
        level, idx, master = 0, lg.index, lg.members[0]
        while master == node and level < self.depth - 1:
            tab = tables[level]
            order = tab["order"]
            if len(order) > 1:
                i = tab["pos"][idx]
                touched.add((level, order[(i - 1) % len(order)]))
                touched.add((level, order[(i + 1) % len(order)]))
            parent_idx = tab["parent"].get(idx)
            if parent_idx is None:
                raise StaleLegionError(
                    f"group {idx} at level {level} has no parent "
                    f"(depth {self.depth}, epoch {self.epoch})")
            touched.add((level + 1, parent_idx))
            level, idx = level + 1, parent_idx
            master = tables[level]["master"][idx]
        return touched

    def _fault_groups_reference(self, node: int) -> set[tuple[int, int]]:
        """Pre-vectorization implementation (per-member Python scans),
        kept as the oracle for the byte-identical-output property tests."""
        lg = self.legion_of(node)
        touched = {(0, lg.index)}
        if self.depth <= 1 or len(self.masters) <= 1:
            return touched
        level, idx, master = 0, lg.index, lg.master
        while master == node and level < self.depth - 1:
            ring = self.groups(level)
            if len(ring) > 1:
                touched.add((level, self.predecessor_at(level, idx).index))
                touched.add((level, self.successor_at(level, idx).index))
            parent = self.parent_of(level, idx)
            touched.add((level + 1, parent.index))
            level, idx, master = level + 1, parent.index, parent.master
        return touched

    def partition_scopes(self, verdict: set[int]) -> list[RepairScope]:
        """Fold an agreed verdict into disjoint :class:`RepairScope`\\ s.
        Scopes whose touched comms intersect are merged (their repairs share
        participants and must serialize); the rest are disjoint subtrees
        that repair concurrently. Verdict nodes no longer in the topology
        (a spare that died warm, a node a previous drain already removed)
        ride along on the first scope so the one-terminal-action-per-fault
        invariant holds for them too.

        Vectorized: participant sets are numpy index arrays unioned with
        ``np.unique``/``np.concatenate``, and the transitive merge is a
        union-find keyed on claimed participants/groups — same equivalence
        classes as the reference fixpoint (two scopes merge iff they share
        a participant or a comm), emitted in the same order (each class is
        represented by its earliest component, and components are created
        in ascending verdict order). ``_partition_scopes_reference`` is the
        retained original; tests assert byte-identical output."""
        present = [n for n in sorted(verdict)
                   if n in self.home and n in self._by_member]
        absent = sorted(set(verdict) - set(present))
        tables = self._scope_tables()
        components: list[tuple[int, set[tuple[int, int]], np.ndarray]] = []
        for n in present:
            groups = self.fault_groups(n)
            arrs = [tables[lvl]["members"][gi] for lvl, gi in groups]
            parts = (np.unique(np.concatenate(arrs)) if arrs
                     else np.empty(0, dtype=np.int64))
            components.append((n, groups, parts))
        # union-find over shared claims — merge on PARTICIPANT overlap, not
        # just shared comms: a node that must enter two repairs (e.g. a
        # legion master pulled into both its local shrink and a neighbour's
        # root-comm shrink at depth 2) serializes them — only truly
        # participant-disjoint scopes may claim concurrency
        root = list(range(len(components)))

        def find(i: int) -> int:
            while root[i] != i:
                root[i] = root[root[i]]
                i = root[i]
            return i

        def union(a: int, b: int) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                # the earlier component absorbs the later one, matching the
                # reference fixpoint's output order
                if rb < ra:
                    ra, rb = rb, ra
                root[rb] = ra

        claimed_group: dict[tuple[int, int], int] = {}
        claimed_part: dict[int, int] = {}
        for i, (_, groups, parts) in enumerate(components):
            for g in groups:
                owner = claimed_group.setdefault(g, i)
                if owner != i:
                    union(i, owner)
            for p in parts.tolist():
                owner = claimed_part.setdefault(p, i)
                if owner != i:
                    union(i, owner)
        merged: dict[int, tuple[set[int], set[tuple[int, int]],
                                list[np.ndarray]]] = {}
        order: list[int] = []
        for i, (n, groups, parts) in enumerate(components):
            r = find(i)
            if r not in merged:
                merged[r] = (set(), set(), [])
                order.append(r)
            m_nodes, m_groups, m_parts = merged[r]
            m_nodes.add(n)
            m_groups |= groups
            m_parts.append(parts)
        verdict_arr = np.asarray(sorted(verdict), dtype=np.int64)
        scopes = []
        for r in order:
            nodes, groups, part_arrs = merged[r]
            parts = np.unique(np.concatenate(part_arrs))
            parts = parts[~np.isin(parts, verdict_arr)]
            scopes.append(RepairScope(
                verdict=tuple(sorted(nodes)),
                level=max(lvl for lvl, _ in groups),
                groups=tuple(sorted(groups)),
                participants=tuple(int(p) for p in parts)))
        if absent:
            if scopes:
                scopes[0] = replace(scopes[0], verdict=tuple(
                    sorted(set(scopes[0].verdict) | set(absent))))
            else:
                scopes = [RepairScope(verdict=tuple(absent), level=0,
                                      groups=(), participants=())]
        return scopes

    def _partition_scopes_reference(self, verdict: set[int]
                                    ) -> list[RepairScope]:
        """Pre-vectorization implementation (set fixpoint over per-member
        scans), kept as the oracle for the byte-identical-output tests."""
        present = [n for n in sorted(verdict)
                   if n in self.home and n in self._by_member]
        absent = sorted(set(verdict) - set(present))
        components: list[tuple[set[int], set[tuple[int, int]], set[int]]] = []
        for n in present:
            groups = set(self._fault_groups_reference(n))
            participants: set[int] = set()
            for lvl, gi in groups:
                participants.update(self.group_at(lvl, gi).members)
            components.append(({n}, groups, participants))
        changed = len(components) > 1
        while changed:                  # transitive closure of the merge
            changed = False
            merged: list[tuple[set[int], set[tuple[int, int]], set[int]]] = []
            for nodes, groups, parts in components:
                for i, (m_nodes, m_groups, m_parts) in enumerate(merged):
                    if (m_parts & parts) or (m_groups & groups):
                        merged[i] = (m_nodes | nodes, m_groups | groups,
                                     m_parts | parts)
                        changed = True
                        break
                else:
                    merged.append((nodes, groups, parts))
            components = merged
        scopes = []
        for nodes, groups, participants in components:
            participants -= set(verdict)
            scopes.append(RepairScope(
                verdict=tuple(sorted(nodes)),
                level=max(lvl for lvl, _ in groups),
                groups=tuple(sorted(groups)),
                participants=tuple(sorted(participants))))
        if absent:
            if scopes:
                scopes[0] = replace(scopes[0], verdict=tuple(
                    sorted(set(scopes[0].verdict) | set(absent))))
            else:
                scopes = [RepairScope(verdict=tuple(absent), level=0,
                                      groups=(), participants=())]
        return scopes

    # ---- snapshots (epoch discipline) ---------------------------------------

    def view(self) -> "TopologyView":
        """Epoch-stamped immutable snapshot for collectives/batch consumers."""
        return TopologyView(self)

    @contextmanager
    def pinned(self) -> Iterator["TopologyView"]:
        """Snapshot AND pin: any mutation while the view is live raises
        :class:`TopologyTornError` instead of silently tearing the structure
        out from under the reader."""
        view = self.view()
        self._pins += 1
        try:
            yield view
        finally:
            self._pins -= 1

    def _mutating(self) -> None:
        if self._pins:
            raise TopologyTornError(
                f"topology mutation attempted while {self._pins} "
                f"TopologyView(s) are pinned at epoch {self.epoch}")
        self.epoch += 1

    # ---- mutation (repair) --------------------------------------------------

    def remove(self, node: int) -> tuple[int, bool]:
        """Exclude a failed node. Returns (legion index, was_master)."""
        lg = self.legion_of(node)
        self._mutating()
        was_master = lg.master == node
        lg.members.remove(node)
        del self._by_member[node]
        return lg.index, was_master

    def compact(self) -> None:
        """Drop empty legions (a legion that lost all members leaves the ring)."""
        if any(not lg.members for lg in self.legions):
            self._mutating()
            self.legions = [lg for lg in self.legions if lg.members]

    def substitute(self, failed: int, spare: int) -> int:
        """Splice ``spare`` into ``failed``'s legion slot. Returns the legion
        index. Preserves the paper's invariants: the spare's assignment is
        final (recorded in ``home``), legion count is unchanged (so the POV
        ring and master-path structure are untouched), and the master stays
        the lowest surviving rank — spare ids are allocated above every
        initial node id, so a substitution never demotes a survivor."""
        if spare in self.home:
            raise ValueError(f"spare {spare} already belongs to legion "
                             f"{self.home[spare]} — assignment is final")
        lg = self.legion_of(failed)
        self._mutating()
        lg.members.remove(failed)
        lg.members.append(spare)
        lg.members.sort()
        del self._by_member[failed]
        self._by_member[spare] = lg
        self.home[spare] = lg.index
        return lg.index

    def expand(self, legion_index: int, node: int) -> None:
        """Re-admit a slot at ``legion_index`` for ``node`` (the deferred half
        of a non-blocking substitution). If the legion left the ring when it
        emptied, it rejoins at its original position — index order is ring
        order at every level, so the POV rings stay consistent."""
        if node in self.home:
            raise ValueError(f"node {node} already belongs to legion "
                             f"{self.home[node]} — assignment is final")
        self._mutating()
        for lg in self.legions:
            if lg.index == legion_index:
                lg.members.append(node)
                lg.members.sort()
                break
        else:
            lg = Legion(index=legion_index, members=[node])
            pos = next((i for i, other in enumerate(self.legions)
                        if other.index > legion_index), len(self.legions))
            self.legions.insert(pos, lg)
        self._by_member[node] = lg
        self.home[node] = legion_index


class TopologyView:
    """Read-only, epoch-stamped snapshot of a :class:`LegionTopology`.

    Collectives and batch planning read from a view, never the live
    topology: the snapshot is deep-copied at construction, so even if the
    pin discipline were bypassed the reader's structure could not change
    underneath it. Mutators are not exposed.
    """

    _MUTATORS = frozenset({"remove", "compact", "substitute", "expand",
                           "view", "pinned"})

    def __init__(self, topo: LegionTopology):
        self.epoch = topo.epoch
        self._snap = LegionTopology(
            k=topo.k,
            legions=[Legion(index=lg.index, members=list(lg.members))
                     for lg in topo.legions],
            home=dict(topo.home),
            epoch=topo.epoch,
            depth=topo.depth,
        )

    def __getattr__(self, name: str):
        if name == "_snap":          # guard recursion during unpickling/init
            raise AttributeError(name)
        if name in TopologyView._MUTATORS:
            raise TypeError(f"TopologyView is read-only: {name}() is not "
                            f"available on a snapshot")
        return getattr(self._snap, name)

    @property
    def node_set(self) -> frozenset[int]:
        return frozenset(self._snap.nodes)

    def restrict(self, exclude: "frozenset[int] | set[int]") -> "TopologyView":
        """A structure-preserving sub-view with ``exclude`` members filtered
        out — the healthy-subtree schedule during a background repair
        window. Unlike a ``make_topology`` rebuild this keeps the original
        legion indices, depth, and **epoch stamp** (per-subtree epoch
        pinning: the survivors' collectives run on the same pinned epoch
        they would without the repair, so excluding a busy scope never
        repartitions the healthy subtrees or changes their alpha-beta
        stage structure). A legion whose members are all busy steps out of
        the ring for the window, exactly as if it had compacted away —
        temporarily, on the view only; the live topology is untouched."""
        busy = self.node_set & frozenset(exclude)
        if not busy:
            return self
        legions = [Legion(index=lg.index,
                          members=[m for m in lg.members if m not in busy])
                   for lg in self._snap.legions]
        view = TopologyView.__new__(TopologyView)
        view.epoch = self.epoch
        view._snap = LegionTopology(
            k=self._snap.k,
            legions=[lg for lg in legions if lg.members],
            home={n: i for n, i in self._snap.home.items() if n not in busy},
            epoch=self._snap.epoch,
            depth=self._snap.depth,
        )
        return view

    def __repr__(self) -> str:
        return (f"TopologyView(epoch={self.epoch}, size={self._snap.size}, "
                f"legions={self._snap.n_legions}, depth={self._snap.depth})")


def make_topology(nodes: list[int], policy: LegioPolicy) -> LegionTopology:
    """Paper-faithful entry point: hierarchical iff size > threshold
    (s > 11), with the depth chosen by ``policy.choose_kd`` — 2 levels in
    the paper's regime, deeper once the master comm itself outgrows the
    threshold (or whatever ``policy.hierarchy_depth`` pins)."""
    s = len(nodes)
    k, depth = policy.choose_kd(s)
    if depth <= 1:
        return LegionTopology.flat(nodes)
    return LegionTopology.build(nodes, k, depth=depth)
