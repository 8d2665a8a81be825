"""Static routing tables for Residual-ViT low-rank-approximator (LRA) paths.

Reimplements the reference's path-coordinate spec (res-vit/model_utils.py:
`_gen_LRA_mask` :14-23, `mapping_table_{1,2,4}` :25-66,
`get_indices_from_LRA_mask` :69-107) with identical outputs — these are
mathematical constants of the routing scheme, baked into jit programs as
static python ints (never traced).

Semantics: a block of `block_size` consecutive layers shares one router
decision vector of `block_size` keep/pass bits per token. The bits pack
big-endian into an integer *path id*. For the layer at position `p` inside
the block, the tables answer: which path ids take the low-rank approximator
at p (`lora`), which run the full transformer at p (`transformer`), and which
pass through untouched (`ste` — computed for completeness; the reference
computes but never consumes it, res-vit/model.py:469-472 reads only [0]/[1]).

Only block sizes 1, 2 and 4 have mapping tables, matching the reference's
supported set (res-vit/model_utils.py:72-79).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# mapping_table[i][j] = path ids whose approximator chain enters at block
# position i and exits at position j (hand-derived in the reference;
# reproduced as spec constants — res-vit/model_utils.py:25-66).
_MAPPING_TABLES: Dict[int, List[List[List[int]]]] = {
    1: [
        [[0],
         []],
    ],
    2: [
        [[1],   # 00
         [0]],  # 01
        [[],    # 10
         [2]],  # 11
    ],
    4: [
        [[4, 5, 6, 7],      # 00
         [2, 3],            # 01
         [1],               # 02
         [0]],              # 03
        [[],                # 10
         [10, 11],          # 11
         [9],               # 12
         [8]],              # 13
        [[],                # 20
         [],                # 21
         [13, 5],           # 22
         [12, 4]],          # 23
        [[],                # 30
         [],                # 31
         [],                # 32
         [2, 6, 10, 14]],   # 33
    ],
}

SUPPORTED_BLOCK_SIZES = tuple(sorted(_MAPPING_TABLES))


def _path_coords(block_size: int, p: int) -> Tuple[list, list, list]:
    """Coordinate sets for block position `p` (res-vit/model_utils.py:14-23):
    (lora, transformer, ste) lists of (enter, exit) coordinates."""
    lora = [(i, p) for i in range(p + 1)]
    transformer = ([(i, jp) for jp in range(p) for i in range(jp + 1)]
                   + [(i, jp) for jp in range(p + 1, block_size)
                      for i in range(p + 1, jp + 1)])
    ste = [(i, jp) for jp in range(p + 1, block_size) for i in range(p + 1)]
    return lora, transformer, ste


def lra_path_ids(block_size: int) -> List[Tuple[List[int], List[int], List[int]]]:
    """Per-block-position `(lora_ids, transformer_ids, ste_ids)` sorted path-id
    lists. The all-keep id `2**block_size - 1` is always a transformer path."""
    if block_size not in _MAPPING_TABLES:
        raise ValueError(
            f"unsupported block_size {block_size}; supported: "
            f"{SUPPORTED_BLOCK_SIZES}")
    table = _MAPPING_TABLES[block_size]
    all_keep = (1 << block_size) - 1
    out = []
    for p in range(block_size):
        lora_c, trans_c, ste_c = _path_coords(block_size, p)
        def ids(coords):
            acc = set()
            for i, j in coords:
                acc.update(table[i][j])
            return sorted(acc)
        lora_ids = ids(lora_c)
        trans_ids = sorted(set(ids(trans_c)) | {all_keep})
        ste_ids = ids(ste_c)
        out.append((lora_ids, trans_ids, ste_ids))
    return out


def path_id_weights(block_size: int) -> List[int]:
    """Big-endian bit weights used to pack keep-bits into a path id
    (res-vit/model.py:169-173)."""
    return [2 ** (block_size - 1 - i) for i in range(block_size)]
