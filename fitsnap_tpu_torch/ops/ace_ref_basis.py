"""Reference-convention ACE basis: labels + generalized Wigner couplings.

Re-implements the behavior of the reference's `lib/sym_ACE` generator
(`gen_labels.py`, `wigner_tree.py`, `rpi_lib.py`) so inputs written for
FitSNAP produce the SAME descriptor functions (same label set, same
ordering, same ctilde coupling tables) as LAMMPS `compute pace` consumes:

  - pairwise ("balanced binary") coupling trees: leaves are coupled in
    adjacent pairs, pair-intermediates are coupled left-to-right, an odd
    leaf joins last (wigner_tree.py rank_N_tree topology);
  - coupling coefficients are products of Wigner 3-j symbols with phase
    (-1)^(sum(L_inter) - sum(M_inter)) for the scalar (L_R=0) case
    (wigner_tree.py:79-265);
  - rank-1/2 have no intermediates; rank-1 couples the radial base only.

Label enumeration for ranks <= 3 is plain lexicographic `generate_nl`
(gen_labels.py:614); ranks >= 4 use the permutation-adapted (minsub /
PA-RPI) reduction, which this module reproduces functionally: enumerate
all tree-distinct (l, L) couplings, then keep one representative per
orbit of simultaneous (mu, n, l) permutations that map trees onto trees
(the "semistandard" Young-subgroup selection of rpi_lib.py).

Validated against the shipped oracle
`examples/Ta_PACE/17Oct22_Standard/coupling_coefficients.yace`.
"""

import itertools
from math import sqrt

import numpy as np

from fitsnap_tpu_torch.ops.cg import cg_block


def _cg(l1, m1, l2, m2, L, M):
    if abs(m1) > l1 or abs(m2) > l2 or m1 + m2 != M or abs(M) > L:
        return 0.0
    return float(cg_block(2 * l1, 2 * l2, 2 * L)[m1 + l1, m2 + l2])


def wigner_3j(l1, m1, l2, m2, l3, m3):
    """(l1 l2 l3; m1 m2 m3) from Clebsch-Gordan tables."""
    if m1 + m2 + m3 != 0:
        return 0.0
    return ((-1.0) ** (l1 - l2 - m3) / sqrt(2 * l3 + 1)
            * _cg(l1, m1, l2, m2, l3, -m3))


def check_triangle(l1, l2, l3):
    return abs(l1 - l2) <= l3 <= l1 + l2


def _pair_nodes(rank):
    """Leaf pairing of the reference tree: ((0,1),(2,3),...), odd leaf last."""
    nodes = tuple((2 * i, 2 * i + 1) for i in range(rank // 2))
    remainder = rank - 1 if rank % 2 else None
    return nodes, remainder


def tree_l_inters(l, L_R=0):
    """Valid intermediate-L tuples for the reference tree topology
    (gen_labels.py tree_l_inters, ranks 1-6)."""
    rank = len(l)
    if rank <= 2:
        return [()]
    nodes, rem = _pair_nodes(rank)
    pair_inters = [range(abs(l[a] - l[b]), l[a] + l[b] + 1)
                   for a, b in nodes]
    out = []
    if rank == 3:
        for L1 in pair_inters[0]:
            if check_triangle(l[rem], L1, L_R):
                out.append((L1,))
    elif rank == 4:
        for L1, L2 in itertools.product(*pair_inters):
            if check_triangle(L1, L2, L_R):
                out.append((L1, L2))
    elif rank == 5:
        for L1, L2 in itertools.product(*pair_inters):
            for L3 in range(abs(L1 - L2), L1 + L2 + 1):
                if check_triangle(l[rem], L3, L_R):
                    out.append((L1, L2, L3))
    elif rank == 6:
        for L1, L2, L3 in itertools.product(*pair_inters):
            for L4 in range(abs(L1 - L2), L1 + L2 + 1):
                if check_triangle(L3, L4, L_R):
                    out.append((L1, L2, L3, L4))
    elif rank == 7:
        # pairs -> L1,L2,L3; L4 = L1(x)L2, L5 = L3(x)l[6]; L4(x)L5 -> L_R
        # (gen_labels.py:438-452)
        for L1, L2, L3 in itertools.product(*pair_inters):
            for L4 in range(abs(L1 - L2), L1 + L2 + 1):
                for L5 in range(abs(L3 - l[rem]), L3 + l[rem] + 1):
                    if check_triangle(L4, L5, L_R):
                        out.append((L1, L2, L3, L4, L5))
    elif rank == 8:
        # pairs -> L1..L4; L5 = L1(x)L2, L6 = L3(x)L4; L5(x)L6 -> L_R
        # (gen_labels.py:453-468)
        for L1, L2, L3, L4 in itertools.product(*pair_inters):
            for L5 in range(abs(L1 - L2), L1 + L2 + 1):
                for L6 in range(abs(L3 - L4), L3 + L4 + 1):
                    if check_triangle(L5, L6, L_R):
                        out.append((L1, L2, L3, L4, L5, L6))
    else:
        raise NotImplementedError(
            f"reference coupling trees implemented for rank <= 8, got {rank}")
    return out


def tree_coupling(l, inter, L_R=0, M_R=0):
    """{m-vector: coefficient} for one (l, L-intermediates) label.

    Phases and 3j products follow wigner_tree.py rank_N_tree exactly:
    w = (-1)^(sum(L) - sum(M) + L_R - M_R) * prod(3j).
    """
    rank = len(l)
    terms = {}
    if rank == 1:
        # w1 = 3j(l1, m1, L_R, M_R, 0, 0) with m1 = -M_R
        if l[0] == L_R:
            c = wigner_3j(l[0], -M_R, L_R, M_R, 0, 0)
            if c != 0.0:
                terms[(-M_R,)] = c
        return terms
    if rank == 2:
        for m1 in range(-l[0], l[0] + 1):
            m2 = M_R - m1
            if abs(m2) > l[1]:
                continue
            c = ((-1.0) ** (L_R - M_R)
                 * wigner_3j(l[0], m1, l[1], m2, L_R, -M_R))
            if c != 0.0:
                terms[(m1, m2)] = c
        return terms

    mranges = [range(-li, li + 1) for li in l]
    if rank == 3:
        (L1,) = inter
        for m1, m2, m3 in itertools.product(*mranges):
            M1 = m1 + m2
            if M1 + m3 != M_R or abs(M1) > L1:
                continue
            w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                 * wigner_3j(L1, M1, l[2], m3, L_R, -M_R))
            w *= (-1.0) ** (L1 - M1 + L_R - M_R)
            if w != 0.0:
                terms[(m1, m2, m3)] = w
    elif rank == 4:
        L1, L2 = inter
        for m1, m2, m3, m4 in itertools.product(*mranges):
            M1, M2 = m1 + m2, m3 + m4
            if M1 + M2 != M_R or abs(M1) > L1 or abs(M2) > L2:
                continue
            w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                 * wigner_3j(l[2], m3, l[3], m4, L2, -M2)
                 * wigner_3j(L1, M1, L2, M2, L_R, -M_R))
            w *= (-1.0) ** (L1 + L2 - M1 - M2 + L_R - M_R)
            if w != 0.0:
                terms[(m1, m2, m3, m4)] = w
    elif rank == 5:
        L1, L2, L3 = inter
        for m1, m2, m3, m4, m5 in itertools.product(*mranges):
            M1, M2 = m1 + m2, m3 + m4
            M3 = M1 + M2
            if M3 + m5 != M_R or abs(M1) > L1 or abs(M2) > L2 \
                    or abs(M3) > L3:
                continue
            w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                 * wigner_3j(l[2], m3, l[3], m4, L2, -M2)
                 * wigner_3j(L1, M1, L2, M2, L3, -M3)
                 * wigner_3j(L3, M3, l[4], m5, L_R, -M_R))
            w *= (-1.0) ** (L1 + L2 + L3 - M1 - M2 - M3 + L_R - M_R)
            if w != 0.0:
                terms[(m1, m2, m3, m4, m5)] = w
    elif rank == 6:
        L1, L2, L3, L4 = inter
        for m1, m2, m3, m4, m5, m6 in itertools.product(*mranges):
            M1, M2, M3 = m1 + m2, m3 + m4, m5 + m6
            M4 = M1 + M2
            if M3 + M4 != M_R or abs(M1) > L1 or abs(M2) > L2 \
                    or abs(M3) > L3 or abs(M4) > L4:
                continue
            w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                 * wigner_3j(l[2], m3, l[3], m4, L2, -M2)
                 * wigner_3j(l[4], m5, l[5], m6, L3, -M3)
                 * wigner_3j(L1, M1, L2, M2, L4, -M4)
                 * wigner_3j(L3, M3, L4, M4, L_R, -M_R))
            w *= (-1.0) ** (L1 + L2 + L3 + L4 - M1 - M2 - M3 - M4
                            + L_R - M_R)
            if w != 0.0:
                terms[(m1, m2, m3, m4, m5, m6)] = w
    elif rank == 7:
        # tree: (m1+m2)->M1, (m3+m4)->M2, (m5+m6)->M3, M1+M2->M4,
        # M3+m7->M5, M4+M5->M_R (wigner_tree.py rank_7_tree).  m7 is fully
        # determined by the projection constraints, so loop pairs only.
        L1, L2, L3, L4, L5 = inter
        for m1, m2, m3, m4, m5, m6 in itertools.product(*mranges[:6]):
            M1, M2, M3 = m1 + m2, m3 + m4, m5 + m6
            M4 = M1 + M2
            if abs(M1) > L1 or abs(M2) > L2 or abs(M3) > L3 or abs(M4) > L4:
                continue
            m7 = M_R - M4 - M3
            M5 = M3 + m7
            if abs(m7) > l[6] or abs(M5) > L5:
                continue
            w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                 * wigner_3j(l[2], m3, l[3], m4, L2, -M2)
                 * wigner_3j(l[4], m5, l[5], m6, L3, -M3)
                 * wigner_3j(L1, M1, L2, M2, L4, -M4)
                 * wigner_3j(L3, M3, l[6], m7, L5, -M5)
                 * wigner_3j(L4, M4, L5, M5, L_R, -M_R))
            w *= (-1.0) ** (L1 + L2 + L3 + L4 + L5
                            - M1 - M2 - M3 - M4 - M5 + L_R - M_R)
            if w != 0.0:
                terms[(m1, m2, m3, m4, m5, m6, m7)] = w
    elif rank == 8:
        # tree: pair sums M1..M4, M1+M2->M5, M3+M4->M6, M5+M6->M_R.  The
        # reference's rank_8_tree (wigner_tree.py:310) crashes on an
        # undefined M6, so this branch is validated by rotational invariance
        # (tests/test_ace_ref_basis.py) rather than against its output.
        L1, L2, L3, L4, L5, L6 = inter
        for m1, m2, m3, m4, m5, m6 in itertools.product(*mranges[:6]):
            M1, M2, M3 = m1 + m2, m3 + m4, m5 + m6
            M5 = M1 + M2
            if abs(M1) > L1 or abs(M2) > L2 or abs(M3) > L3 or abs(M5) > L5:
                continue
            M6 = M_R - M5
            M4 = M6 - M3
            if abs(M6) > L6 or abs(M4) > L4:
                continue
            for m7 in mranges[6]:
                m8 = M4 - m7
                if abs(m8) > l[7]:
                    continue
                w = (wigner_3j(l[0], m1, l[1], m2, L1, -M1)
                     * wigner_3j(l[2], m3, l[3], m4, L2, -M2)
                     * wigner_3j(l[4], m5, l[5], m6, L3, -M3)
                     * wigner_3j(l[6], m7, l[7], m8, L4, -M4)
                     * wigner_3j(L1, M1, L2, M2, L5, -M5)
                     * wigner_3j(L3, M3, L4, M4, L6, -M6)
                     * wigner_3j(L5, M5, L6, M6, L_R, -M_R))
                w *= (-1.0) ** (L1 + L2 + L3 + L4 + L5 + L6
                                - M1 - M2 - M3 - M4 - M5 - M6 + L_R - M_R)
                if w != 0.0:
                    terms[(m1, m2, m3, m4, m5, m6, m7, m8)] = w
    else:
        raise NotImplementedError(
            f"reference coupling trees implemented for rank <= 8, got {rank}")
    return {k: v for k, v in terms.items() if abs(v) > 1e-16}


def generate_l_vectors(lrng, rank, L_R=0, use_permutations=False):
    """l-vectors admitting at least one valid tree coupling to L_R, with
    inversion parity sum(l) ≡ L_R (mod 2) (gen_labels.py generate_l_LR)."""
    if rank == 1:
        return [(L_R,)]
    inv_even = (L_R % 2 == 0)
    cands = itertools.product(lrng, repeat=rank)
    out = []
    for ltup in cands:
        if not use_permutations and ltup != tuple(sorted(ltup)):
            continue
        parity = (sum(ltup) % 2 == 0)
        if parity != inv_even:
            continue
        if rank == 2:
            if check_triangle(ltup[0], ltup[1], L_R):
                out.append(ltup)
            continue
        if tree_l_inters(list(ltup), L_R):
            out.append(ltup)
    return out


# ---------------------------------------------------------------------------
# label enumeration
# ---------------------------------------------------------------------------

def generate_nl_labels(rank, nmax, lmax, mumax=1, lmin=0, L_R=0):
    """All-inters lexicographic labels (gen_labels.py generate_nl):
    slot triples (mu_i, l_i, n_i) must be sorted; every valid intermediate
    tuple is a separate label.  Returns [(mus, ns, ls, Ls)]."""
    labels = []
    lvecs = generate_l_vectors(range(lmin, lmax + 1), rank, L_R,
                               use_permutations=True)
    for mus in itertools.product(range(mumax), repeat=rank):
        for ns in itertools.product(range(1, nmax + 1), repeat=rank):
            for ls in lvecs:
                trip = [(mus[i], ls[i], ns[i]) for i in range(rank)]
                if trip != sorted(trip):
                    continue
                for inter in tree_l_inters(list(ls), L_R):
                    labels.append((tuple(mus), tuple(ns), tuple(ls),
                                   tuple(inter)))
    # generate_nl dedupes via set(); order is restored by sort_labels
    seen = set()
    out = []
    for lab in labels:
        if lab not in seen:
            seen.add(lab)
            out.append(lab)
    return out


def _tree_group(rank):
    """Leaf permutations that map the pairwise coupling tree onto itself:
    swapping the two leaves inside any pair, swapping sibling pairs that
    feed the same internal node (pairs 0,1 for ranks 4-7; also pairs 2,3
    and the two super-nodes for rank 8).  Returns a list of index tuples
    p with p[i] = source slot of new slot i."""
    nodes, rem = _pair_nodes(rank)
    k = len(nodes)
    pair_orders = [list(range(k))]
    if k >= 2:
        pair_orders = [[1, 0] + list(range(2, k))] + pair_orders
    if k == 4:
        # rank 8: pairs (2,3) feed L6 like (0,1) feed L5, and the two
        # super-nodes L5/L6 feed L_R symmetrically
        orders = []
        for o in ([0, 1], [1, 0]):
            for p in ([2, 3], [3, 2]):
                orders.append(o + p)
                orders.append(p + o)
        pair_orders = orders
    perms = []
    for flips in itertools.product([False, True], repeat=k):
        for order in pair_orders:
            idx = []
            for pi in order:
                a, b = nodes[pi]
                idx += [b, a] if flips[pi] else [a, b]
            if rem is not None:
                idx.append(rem)
            perms.append(tuple(idx))
    return perms


def _canonical_slots(mus, ns, ls, group):
    """Lexicographic-min representative of (ls, ns, mus) under the tree
    group (the YSG 'semistandard' selection keeps exactly these reps)."""
    best = None
    for p in group:
        cand = (tuple(ls[i] for i in p), tuple(ns[i] for i in p),
                tuple(mus[i] for i in p))
        if best is None or cand < best:
            best = cand
    return best


def pa_labels(rank, nmax, lmax, mumax=1, lmin=0, L_R=0):
    """Permutation-adapted labels for rank >= 4 (the minsub / YSG basis of
    rpi_lib.py descriptor_labels_YSG): one canonical (mu, n, l) slot
    assignment per orbit of the tree-symmetry group, carrying only the
    MAXIMAL intermediate-L tuple.  Validated against the Ta_PACE standard
    (29 rank-4 + 1 rank-6 functions with matching ms-comb counts)."""
    group = _tree_group(rank)
    labels = []
    seen = set()
    lvecs = generate_l_vectors(range(lmin, lmax + 1), rank, L_R,
                               use_permutations=True)
    for ls in sorted(set(lvecs)):
        uniform_l = len(set(ls)) == 1
        for ns in itertools.product(range(1, nmax + 1), repeat=rank):
            for mus in itertools.product(range(mumax), repeat=rank):
                if uniform_l:
                    # all slots carry the same l: recoupling identities make
                    # different arrangements of one (mu, n) multiset linearly
                    # dependent — keep only the sorted representative
                    slots = [(mus[i], ns[i]) for i in range(rank)]
                    if slots != sorted(slots):
                        continue
                else:
                    key = _canonical_slots(mus, ns, ls, group)
                    if key != (ls, ns, mus):
                        continue
                if (ls, ns, mus) in seen:
                    continue
                seen.add((ls, ns, mus))
                inters = tree_l_inters(list(ls), L_R)
                if not inters:
                    continue
                labels.append((tuple(mus), tuple(ns), tuple(ls),
                               tuple(max(inters))))
    return labels


def _pa_block(pattern, lvec):
    """PA-RPI label content of one tabulated block (pa_gen.py
    build_tabulated): distinct slot-class arrangements + the ladder-selected
    intermediate L tuples, for rank-4 blocks.

    Implemented for the uniform lvec (1,1,1,1) (covers every shipped
    pa_tabulated example; validated against
    lib/sym_ACE/lib/all_labels_mu8_n12_l12_r4.json):
      pattern 0000 -> [(0000, (0,0))]
      pattern 0001 -> [(0001, (0,0))]
      pattern 0011 -> [(0011, (0,0)), (0101, (0,0))]
      pattern 0012 -> [(0012, (0,0)), (0102, (0,0))]
      pattern 0123 -> [(0123, (0,0)), (0213, (0,0)), (0312, (0,0))]
    i.e. the distinct perfect matchings of the class multiset, coupled at
    the minimal (0,0) intermediates.
    """
    if tuple(lvec) != (1, 1, 1, 1):
        raise NotImplementedError(
            "pa_tabulated rank-4 blocks are implemented for lmax=1 "
            f"(l = (1,1,1,1)); got l = {tuple(lvec)}. Use b_basis = minsub "
            "for higher angular momenta.")
    classes = list(pattern)
    # enumerate the 3 pairings of 4 slots; dedupe by pair-multiset
    pairings = [((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))]
    seen = set()
    out = []
    for pr in pairings:
        pairs = sorted(tuple(sorted((classes[a], classes[b])))
                       for a, b in pr)
        key = tuple(pairs)
        if key in seen:
            continue
        seen.add(key)
        arrangement = tuple(pairs[0] + pairs[1])
        out.append((arrangement, (0, 0)))
    return out


def pa_tabulated_labels(rank, nmax, lmax, mumax=1, lmin=0, L_R=0):
    """pa_tabulated (PA-RPI) labels (pa_gen.py pa_labels_raw): for rank >= 4
    map (mu, n) slot-pair multisets to tabulated block patterns (classes
    ordered by count desc, then value; gen_labels.py get_mapped) and expand
    the block's arrangements back to (mus, ns)."""
    if rank < 4:
        return generate_nl_labels(rank, nmax, lmax, mumax, lmin, L_R)
    if rank > 4:
        raise NotImplementedError(
            "pa_tabulated label generation implemented for rank <= 4; "
            "use b_basis = minsub for higher ranks")
    labels = []
    seen_nl = set()
    lvecs = generate_l_vectors(range(lmin, lmax + 1), rank, L_R,
                               use_permutations=False)
    n_multisets = list(itertools.combinations_with_replacement(
        range(1, nmax + 1), rank))
    mu_multisets = list(itertools.combinations_with_replacement(
        range(mumax), rank))
    for mu_ms in mu_multisets:
        for n_ms in n_multisets:
            for ls in lvecs:
                # unique multisets of combined (n, mu) slot pairs over all
                # pairings of the two multisets (muvec_nvec_combined)
                combos = set()
                for mus_p in set(itertools.permutations(mu_ms)):
                    pairs = tuple(sorted(zip(n_ms, mus_p)))
                    combos.add(pairs)
                for pairs in sorted(combos):
                    # class indices ordered by count desc, then pair value
                    from collections import Counter
                    cnt = Counter(pairs)
                    uniq = sorted(cnt, key=lambda p: (-cnt[p], p))
                    cls = {p: i for i, p in enumerate(uniq)}
                    slots = sorted(pairs, key=lambda p: (-cnt[p], p))
                    pattern = tuple(cls[p] for p in slots)
                    inv = {i: p for p, i in cls.items()}
                    for arrangement, L in _pa_block(pattern, ls):
                        ns = tuple(inv[c][0] for c in arrangement)
                        mus = tuple(inv[c][1] for c in arrangement)
                        key = (mus, ns, ls, L)
                        if key in seen_nl:
                            continue
                        seen_nl.add(key)
                        labels.append((mus, ns, ls, tuple(L)))
    return labels


def _label_string(mu0, mus, ns, ls, Ls):
    """The reference's nu-string format mu0_mu,...,n,...,l,..._L1-L2-..."""
    body = ",".join(str(x) for x in (list(mus) + list(ns) + list(ls)))
    tail = "-".join(str(x) for x in Ls)
    return f"{mu0}_{body}_{tail}"


def sort_labels(labels):
    """The ACE section's ordering (reference ace.py:96-114): stable sorts
    by mu-tuple, n-tuple, l-tuple, mu0, then nu-string length, then mu0 —
    i.e. primary mu0, then string length, then l, n, mu."""
    labs = list(labels)
    labs.sort(key=lambda lab: lab[1])          # mus
    labs.sort(key=lambda lab: lab[2])          # ns
    labs.sort(key=lambda lab: lab[3])          # ls
    labs.sort(key=lambda lab: lab[0])          # mu0
    labs.sort(key=lambda lab: len(_label_string(*lab)))
    labs.sort(key=lambda lab: lab[0])          # mu0 (srt_by_attyp)
    return labs


def reference_labels_and_terms(section):
    """Full label list + coupling term maps for a FitSNAP [ACE] section.

    Returns (labels, terms) where labels are (mu0, mus, ns, ls, Ls) tuples
    in the reference's blist order and terms[i] is {m-vector: ctilde}.
    """
    numtypes = section.numtypes
    basis = getattr(section, "b_basis", "minsub")
    raw = []
    for idx, rank in enumerate(section.ranks):
        nmx = section.nmax[idx]
        lmx = section.lmax[idx]
        lmn = section.lmin[idx]
        if rank < 4:
            raw += generate_nl_labels(rank, nmx, lmx, numtypes, lmn)
        elif basis == "pa_tabulated":
            try:
                raw += pa_tabulated_labels(rank, nmx, lmx, numtypes, lmn)
            except NotImplementedError as exc:
                # default basis is pa_tabulated (reference ace.py:43); for
                # rank/l spaces its tabulation does not cover, fall back to
                # the minsub (YSG) basis instead of hard-failing
                import warnings
                warnings.warn(
                    f"pa_tabulated basis unavailable for rank={rank}, "
                    f"lmax={lmx} ({exc}); falling back to minsub (YSG) "
                    "labels for this rank", stacklevel=2)
                raw += pa_labels(rank, nmx, lmx, numtypes, lmn)
        else:
            raw += pa_labels(rank, nmx, lmx, numtypes, lmn)
    per_mu0 = sort_labels([(mu0,) + lab for lab in raw
                           for mu0 in [0]])
    # replicate the per-mu0 label block for every central element
    labels = []
    for mu0 in range(numtypes):
        labels += [(mu0,) + lab[1:] for lab in per_mu0]
    terms = []
    cache = {}
    for (mu0, mus, ns, ls, Ls) in labels:
        key = (ls, Ls)
        if key not in cache:
            cache[key] = tree_coupling(list(ls), tuple(Ls))
        terms.append(cache[key])
    return labels, terms
