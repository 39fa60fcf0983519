"""K5, ``score_candidates(flat, reads, cand, match, mismatch, gap_code)``:
the aligner's candidate scoring, five int32 outputs a candidate.

Bytes: the genome bytes the candidate windows cover (each once), the reads
(int8), the candidates (int32) and the five outputs.  Operations: a
compare, an add and a minimum per base of each candidate window.
"""

import torch


def count(flat, reads, cand, match, mismatch, gap_code):
    B, L = reads.shape
    starts = cand.reshape(-1).to(torch.int64).sort().values
    covered = torch.diff(starts).clamp(max=L).sum() + L
    n_bytes = covered + reads.numel() + cand.numel() * 4 * (1 + 5)
    return n_bytes, 3 * cand.numel() * L
