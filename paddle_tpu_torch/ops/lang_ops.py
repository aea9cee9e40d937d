"""Beam-search decoding ops: one dense beam-search step and the
backtrace of the beams' parents.

Reference: operators/beam_search_op.cc and gather_tree_op.cc, which
walk LoD beams on the CPU.  As in the JAX package (ops/lang_ops.py
beam_search, gather_tree), the beams are a static [B, K] block and no
beam is pruned: a finished beam (its last id is end_id) can only be
extended by end_id, at zero added score.
"""

import torch

from .registry import register


def _top_k(x, k):
    """The k largest of each row of x, largest first; equal values keep
    their order (lower index first, as jax.lax.top_k gives them), through
    a stable sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register('beam_search',
          no_grad_out_slots=('SelectedIds', 'SelectedScores', 'ParentIdx'))
def beam_search(ctx, ins, attrs):
    """PreIds [B,K], PreScores [B,K], Scores [B,K,V] (log-probs) ->
    SelectedIds [B,K], SelectedScores [B,K], ParentIdx [B,K] (int64)."""
    pre_ids = ins['PreIds'][0]
    pre_scores = ins['PreScores'][0]
    scores = ins['Scores'][0]
    b, k, v = scores.shape
    end_id = int(attrs.get('end_id', 1))
    finished = (pre_ids == end_id)[..., None]  # [B, K, 1]
    frozen = torch.full((v,), -1e9, dtype=scores.dtype,
                        device=scores.device)
    frozen[end_id] = 0.0
    total = pre_scores[..., None] + torch.where(finished, frozen, scores)
    sel_scores, flat_idx = _top_k(total.reshape(b, k * v), k)
    return {'SelectedIds': [flat_idx % v], 'SelectedScores': [sel_scores],
            'ParentIdx': [torch.div(flat_idx, v, rounding_mode='floor')]}


@register('gather_tree', no_grad_out_slots=('Out',))
def gather_tree(ctx, ins, attrs):
    """Backtrace of the beams' parents into whole sequences: Ids
    [T,B,K], Parents [T,B,K] -> Out [T,B,K] (int64); the walk starts
    from each beam at the last step."""
    ids = ins['Ids'][0].long()
    parents = ins['Parents'][0].long()
    t, b, k = ids.shape
    beam = torch.arange(k, device=ids.device).expand(b, k)
    out = [None] * t
    for s in range(t - 1, -1, -1):
        out[s] = torch.gather(ids[s], 1, beam)
        beam = torch.gather(parents[s], 1, beam)
    return {'Out': [torch.stack(out)]}
