"""Structured-prediction and language ops: the linear-chain CRF and its
Viterbi decode, chunk_eval, CTC (warpctc, ctc_align, edit_distance),
the sampling losses (nce, hierarchical_sigmoid, sample_logits),
cos_sim, the text-matching ops (pyramid_hash, filter_by_instag,
var_conv_2d, tree_conv) and beam-search decoding (beam_search,
gather_tree).

Reference: operators/linear_chain_crf_op.h, crf_decoding_op.h,
chunk_eval_op.h, warpctc_op.cc, ctc_align_op.h, edit_distance_op.h,
nce_op.h, hierarchical_sigmoid_op.h, sample_logits_op.cc, cos_sim_op.h,
pyramid_hash_op.cc, filter_by_instag_op.cc, var_conv_2d_op.cc,
tree_conv_op.cc, beam_search_op.cc and gather_tree_op.cc, which walk LoD
sequences with scalar C++ loops.  As in the JAX package
(ops/lang_ops.py), every op works on padded [B, T] batches with explicit
lengths, and autograd over the same lowering gives the gradient.

Three rules keep each op a function of device values that a CUDA graph
can replay and that gives the same bits at every launch:

- no host read: recursions over time run a Python loop of batched
  steps, frozen past each sequence's length with ``torch.where``;
- no float atomics: a row gather whose rows may repeat goes through
  the embedding gather (``kernels.embedding.embedding_lookup``: its
  gradient is the sorted scatter-add), and a selection or a scatter
  by label is a one-hot product;
- draws come from the counter hash of the dropout op
  (``kernels.dropout.hash_bits``) under a seed of the program's seed,
  the op's seed attr and the device step (``LowerCtx.sample_seed``),
  not from jax threefry, which PyTorch cannot reproduce.

The beams of beam_search are a static [B, K] block and no beam is
pruned: a finished beam (its last id is end_id) can only be extended
by end_id, at zero added score.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import dropout as _hash
from .kernels.embedding import embedding_lookup
from .kernels.flash_attention import mul32
from .registry import device_constant, register, register_host


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
    # a fill, not an item assignment: that copies a host scalar, which a
    # CUDA graph capture refuses
    frozen.narrow(0, end_id, 1).fill_(0.0)
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


# ------------------------------------------------------------- shared

def _lengths_of(ins, b, t, like, slot='Length'):
    """Length [B] (int64) from the named slot, else every row full."""
    if ins.get(slot):
        return ins[slot][0].reshape(-1).long()
    return torch.full((b,), t, dtype=torch.int64, device=like.device)


def _labels(ins, slot='Label'):
    label = ins[slot][0].long()
    return label[..., 0] if label.ndim == 3 else label


def _one_hot(idx, n, dtype):
    """idx [...] -> [..., n] with 1 at idx: a selection by label becomes
    a product whose gradient is a reduction, not a scatter."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _select(x, idx):
    """x[..., idx] along the last axis by a one-hot product: exact (one
    term and zeros), and its gradient adds without atomics."""
    return (x * _one_hot(idx, x.shape[-1], x.dtype)).sum(-1)


def _take_rows(x, idx):
    """x [N, K] at idx [N, M] along axis 1 through the embedding gather
    of the flattened x, whose gradient is the sorted scatter-add: a
    column picked twice in a row sums in a fixed order."""
    n, k = x.shape
    flat = idx + torch.arange(n, device=idx.device)[:, None] * k
    return embedding_lookup(x.reshape(-1, 1), flat)[..., 0]


def _softplus(z):
    """log(1 + exp(z)) as jax.nn.softplus computes it (logaddexp(z, 0)),
    with no threshold."""
    return torch.logaddexp(z, torch.zeros_like(z))


def _uniform(ctx, attrs, shape, device, salt=1):
    """(24-bit counter-hash draws [shape] int64, the same as f32 in
    [0, 1)) keyed by LowerCtx.sample_seed(salt + the op's seed attr)."""
    seed = ctx.sample_seed(salt + int(attrs.get('seed', 0) or 0))
    bits = _hash.hash_bits(seed, shape, device).long()
    return bits, bits.to(torch.float32) * (2.0 ** -24)


# --------------------------------------------------------------- CRF

def _crf_alpha(x, lengths, w_start, w):
    """The log-domain forward table [B, T, D] and its last live row:
    alpha_k = logsumexp_i(alpha_{k-1, i} + w[i, :]) + x_k, frozen past
    each row's length."""
    alpha = w_start + x[:, 0]
    rows = [alpha]
    for k in range(1, x.shape[1]):
        new = torch.logsumexp(alpha[:, :, None] + w, dim=1) + x[:, k]
        alpha = torch.where((k < lengths)[:, None], new, alpha)
        rows.append(alpha)
    return alpha, torch.stack(rows, 1)


@register('linear_chain_crf',
          no_grad_out_slots=('Alpha', 'EmissionExps', 'TransitionExps'))
def linear_chain_crf(ctx, ins, attrs):
    """Emission [B,T,D], Transition [D+2,D] (row 0 start, row 1 end,
    rows 2.. pairwise), Label [B,T], Length [B] -> LogLikelihood [B,1]
    (the cost -ll, linear_chain_crf_op.h:216), Alpha [B,T,D] (the
    log-domain forward table; the reference keeps it L1-normalized),
    EmissionExps exp(x - rowmax), TransitionExps exp(Transition)."""
    x = ins['Emission'][0]
    trans = ins['Transition'][0]
    label = _labels(ins)
    b, t, d = x.shape
    lengths = _lengths_of(ins, b, t, x)
    w_start, w_end, w = trans[0], trans[1], trans[2:]
    alpha_last, alpha = _crf_alpha(x, lengths, w_start, w)
    log_z = torch.logsumexp(alpha_last + w_end, dim=1)
    mask = (torch.arange(t, device=x.device)[None, :] <
            lengths[:, None]).to(x.dtype)
    oh = _one_hot(label, d, x.dtype)
    emit = ((x * oh).sum(-1) * mask).sum(1)
    # w[label_k, label_k+1]: the row of label_k, then its column
    pair = ((oh[:, :-1, :, None] * w).sum(2) * oh[:, 1:]).sum(-1)
    pair = (pair * mask[:, 1:]).sum(1)
    last = label.gather(1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    score = (w_start * oh[:, 0]).sum(-1) + emit + pair + \
        _select(w_end, last)
    return {'LogLikelihood': [(log_z - score)[:, None]],
            'Alpha': [alpha],
            'EmissionExps': [torch.exp(x - x.max(-1, keepdim=True)[0])],
            'TransitionExps': [torch.exp(trans)]}


def _viterbi(x, lengths, w_start, w_end, w):
    """Viterbi paths [B, T] (int64, 0 past each length).  Ties take the
    lower tag (torch.argmax returns the first maximum, as jnp.argmax
    does); past a row's length its backpointers are the identity, so the
    last live tag carries back unchanged."""
    b, t, d = x.shape
    ident = torch.arange(d, device=x.device).expand(b, d)
    alpha = w_start + x[:, 0]
    bps = []
    for k in range(1, t):
        scores = alpha[:, :, None] + w                    # [B, from, to]
        bp = torch.argmax(scores, dim=1)
        best = scores.gather(1, bp[:, None, :])[:, 0] + x[:, k]
        live = (k < lengths)[:, None]
        alpha = torch.where(live, best, alpha)
        bps.append(torch.where(live, bp, ident))
    tag = torch.argmax(alpha + w_end, dim=1)
    path = [None] * t
    for k in range(t - 1, 0, -1):
        path[k] = tag
        tag = bps[k - 1].gather(1, tag[:, None])[:, 0]
    path[0] = tag
    path = torch.stack(path, 1)
    inside = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    return torch.where(inside, path, torch.zeros_like(path)), inside


@register('crf_decoding', no_grad_out_slots=('ViterbiPath',))
def crf_decoding(ctx, ins, attrs):
    """Viterbi decode -> ViterbiPath [B,T] int64; with Label, each
    position's correctness 0/1 instead of the path
    (crf_decoding_op.h:99)."""
    x = ins['Emission'][0]
    trans = ins['Transition'][0]
    b, t, _ = x.shape
    path, inside = _viterbi(x, _lengths_of(ins, b, t, x), trans[0],
                            trans[1], trans[2:])
    if ins.get('Label'):
        path = (inside & (_labels(ins) == path)).long()
    return {'ViterbiPath': [path]}


# -------------------------------------------------------- chunk_eval

_CHUNK_SCHEMES = {
    # scheme: (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    'IOB': (2, 0, 1, -1, -1),
    'IOE': (2, -1, 0, 1, -1),
    'IOBES': (4, 0, 1, 2, 3),
    'plain': (1, -1, -1, -1, -1),
}


def _chunk_end(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    if prev_type == other:
        return False
    if type_ == other:
        return True
    if type_ != prev_type:
        return True
    if prev_tag == tb or prev_tag == ti:
        return tag == tb or tag == ts
    if prev_tag == te or prev_tag == ts:
        return True
    return False


def _chunk_begin(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    if prev_type == other:
        return type_ != other
    if type_ == other:
        return False
    if type_ != prev_type:
        return True
    if tag == tb or tag == ts:
        return True
    if tag == ti or tag == te:
        return prev_tag == te or prev_tag == ts
    return False


def _get_segments(labels, num_tag_types, other, tb, ti, te, ts):
    """The chunks (start, end, type) of one label sequence
    (chunk_eval_op.h GetSegments)."""
    segments = []
    chunk_start, in_chunk = 0, False
    tag, type_ = -1, other
    for i, lab in enumerate(labels):
        prev_tag, prev_type = tag, type_
        tag = int(lab) % num_tag_types
        type_ = int(lab) // num_tag_types
        if in_chunk and _chunk_end(prev_tag, prev_type, tag, type_,
                                   other, tb, ti, te, ts):
            segments.append((chunk_start, i - 1, prev_type))
            in_chunk = False
        if _chunk_begin(prev_tag, prev_type, tag, type_,
                        other, tb, ti, te, ts):
            chunk_start = i
            in_chunk = True
    if in_chunk:
        segments.append((chunk_start, len(labels) - 1, type_))
    return segments


def chunk_counts(infer, label, lengths, scheme, num_chunk_types,
                 excluded=()):
    """(inferred, labelled, correct) chunk counts over numpy [B, T]
    label rows, each cut at its length."""
    num_tag_types, tb, ti, te, ts = _CHUNK_SCHEMES[scheme]
    other = int(num_chunk_types)
    excluded = set(excluded)
    n_infer = n_label = n_correct = 0
    for i in range(infer.shape[0]):
        ln = int(lengths[i])
        segs = [[s for s in _get_segments(rows[i, :ln], num_tag_types,
                                         other, tb, ti, te, ts)
                 if s[2] not in excluded] for rows in (infer, label)]
        n_infer += len(segs[0])
        n_label += len(segs[1])
        n_correct += len(set(segs[0]) & set(segs[1]))
    return n_infer, n_label, n_correct


@register_host('chunk_eval', runs=True)
def chunk_eval(ctx, op, ins):
    """Chunk precision, recall and F1 on the host (the reference runs it
    on the CPU too; a plan holding it is never captured in a CUDA
    graph).  Inference and Label [B, T] (or [B, T, 1]), SeqLength [B]."""
    def host(v):
        a = v.detach().cpu().numpy()
        return a[..., 0] if a.ndim == 3 else a
    infer, label = host(ins['Inference'][0]), host(ins['Label'][0])
    if ins.get('SeqLength'):
        lengths = host(ins['SeqLength'][0]).reshape(-1)
    else:
        lengths = np.full((infer.shape[0],), infer.shape[1], np.int64)
    n_infer, n_label, n_correct = chunk_counts(
        infer, label, lengths, op.attrs.get('chunk_scheme', 'IOB'),
        op.attrs['num_chunk_types'],
        op.attrs.get('excluded_chunk_types') or ())
    p = n_correct / n_infer if n_infer else 0.0
    r = n_correct / n_label if n_label else 0.0
    f1 = 2 * p * r / (p + r) if n_correct else 0.0
    outs = {'Precision': np.array([p], np.float32),
            'Recall': np.array([r], np.float32),
            'F1-Score': np.array([f1], np.float32),
            'NumInferChunks': np.array([n_infer], np.int64),
            'NumLabelChunks': np.array([n_label], np.int64),
            'NumCorrectChunks': np.array([n_correct], np.int64)}
    return {slot: [torch.as_tensor(v, device=ctx.device)]
            for slot, v in outs.items() if op.output(slot)}


# --------------------------------------------------------------- CTC

_LOG_EPSILON = -1e5  # optax.ctc_loss's log(+0)


def _ctc_loss(logits, logit_pad, labels, label_pad, blank):
    """optax.ctc_loss (Graves et al. 2006) as the JAX package's warpctc
    runs it, step for step: logits (not log-probs) in, and an
    infeasible alignment costs a large finite loss (log 0 is
    log_epsilon -1e5), not inf.  [B] losses."""
    b, t, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, -1)
    labellens = n - label_pad.sum(1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype),
                   (0, 1))
    lp_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)   # [T, B, 1]
    # the label columns by a one-hot product (exact in f32), as optax
    lp_emit = torch.einsum('btk,bnk->btn', logprobs,
                           _one_hot(labels, k, logits.dtype)
                           ).transpose(0, 1)                   # [T, B, N]
    eps = _LOG_EPSILON
    phi = F.pad(torch.full((b, n), eps, dtype=logits.dtype,
                           device=logits.device), (1, 0))
    emit = torch.full((b, n), eps, dtype=logits.dtype, device=logits.device)

    def add_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         1)

    pads = logit_pad.t()
    for s in range(t):
        phi_orig = phi
        phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[s],
                                    emit + lp_emit[s])
        next_phi = add_phi(phi + lp_phi[s],
                           emit + lp_phi[s] + eps * (1.0 - repeat))
        pad = pads[s][:, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi = add_phi(phi, emit)
    return -(phi * _one_hot(labellens, n + 1, phi.dtype)).sum(1)


@register('warpctc', no_grad_out_slots=('WarpCTCGrad',))
def warpctc(ctx, ins, attrs):
    """CTC loss on padded batches (the reference dlopens warp-ctc):
    Logits [B,T,V], Label [B,L], LogitsLength [B], LabelLength [B] ->
    Loss [B,1]; WarpCTCGrad zeros, as in the JAX package (autograd gives
    the gradient)."""
    logits = ins['Logits'][0]
    label = ins['Label'][0].long()
    b, t, _ = logits.shape
    lo_len = _lengths_of(ins, b, t, logits, 'LogitsLength')
    la_len = _lengths_of(ins, b, label.shape[1], logits, 'LabelLength')
    logit_pad = (torch.arange(t, device=logits.device)[None, :] >=
                 lo_len[:, None]).to(logits.dtype)
    label_pad = (torch.arange(label.shape[1], device=logits.device)[None, :]
                 >= la_len[:, None]).to(logits.dtype)
    loss = _ctc_loss(logits, logit_pad, label, label_pad,
                     int(attrs.get('blank', 0)))
    if attrs.get('norm_by_times'):
        loss = loss / lo_len.to(loss.dtype).clamp(min=1.0)
    return {'Loss': [loss[:, None]],
            'WarpCTCGrad': [torch.zeros_like(logits)]}


def _compact(x, keep):
    """Each row's kept elements moved to its front in order (a stable
    sort of ~keep), and the count kept per row."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True)[1]
    return torch.gather(x, 1, order), keep.sum(1)


@register('ctc_align', no_grad_out_slots=('Output', 'OutputLength'))
def ctc_align(ctx, ins, attrs):
    """Greedy CTC decode: merge repeats, then drop blanks
    (ctc_align_op.h).  Input [B,T] int, InputLength [B] -> Output [B,T]
    left-aligned and padded with padding_value, OutputLength [B,1]."""
    x = ins['Input'][0].long()
    b, t = x.shape
    lengths = _lengths_of(ins, b, t, x, 'InputLength')
    pos = torch.arange(t, device=x.device)[None, :]
    prev = F.pad(x[:, :-1], (1, 0), value=-1)
    keep = (x != int(attrs.get('blank', 0))) & (x != prev) & \
        (pos < lengths[:, None])
    out, out_len = _compact(x, keep)
    out = torch.where(pos < out_len[:, None], out,
                      torch.full_like(out, int(attrs.get('padding_value',
                                                         0))))
    return {'Output': [out], 'OutputLength': [out_len[:, None]]}


def _remove_tokens(x, lengths, tokens):
    """Drop the given ids from padded [B, L] rows: (compacted rows, new
    lengths)."""
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < \
        lengths[:, None]
    for tok in tokens:
        keep &= x != int(tok)
    return _compact(x, keep)


def _levenshtein(hyp, ref, h_len, r_len):
    """[B] f32 edit distances of hyp[b, :h_len[b]] and ref[b, :r_len[b]]:
    the (L1+1) x (L2+1) table filled an anti-diagonal at a time (every
    cell of diagonal i + j needs only the two diagonals before it), so
    L1 + L2 - 1 batched steps instead of L1 x L2 scalar ones.  The values
    are small integers, exact in f32."""
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    table = (torch.arange(l1 + 1, device=dev)[:, None] +
             torch.arange(l2 + 1, device=dev)[None, :]).to(torch.float32)
    inner = torch.ones(l1 + 1, l2 + 1, dtype=torch.bool, device=dev)
    inner[0, :] = False
    inner[:, 0] = False
    # border cells hold i + j = max(i, j); inner ones are filled below
    table = table.expand(b, l1 + 1, l2 + 1).clone()
    for d in range(2, l1 + l2 + 1):
        lo, hi = max(1, d - l2), min(l1, d - 1)
        if lo > hi:
            continue
        i = torch.arange(lo, hi + 1, device=dev)
        j = d - i
        sub = table[:, i - 1, j - 1] + \
            (hyp[:, i - 1] != ref[:, j - 1]).to(torch.float32)
        dele = table[:, i - 1, j] + 1.0
        ins = table[:, i, j - 1] + 1.0
        table[:, i, j] = torch.minimum(torch.minimum(sub, dele), ins)
    return table[torch.arange(b, device=dev), h_len, r_len]


@register('edit_distance', no_grad_out_slots=('Out', 'SequenceNum'))
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance of padded int sequences (edit_distance_op.h):
    Hyps [B,L1], Refs [B,L2] (+ HypsLength, RefsLength) -> Out [B,1] f32
    (over the reference's length with `normalized`), SequenceNum [1]
    int64."""
    hyp = ins['Hyps'][0].long()
    ref = ins['Refs'][0].long()
    b, l1 = hyp.shape
    h_len = _lengths_of(ins, b, l1, hyp, 'HypsLength')
    r_len = _lengths_of(ins, b, ref.shape[1], hyp, 'RefsLength')
    ignored = attrs.get('ignored_tokens') or ()
    if len(ignored):
        hyp, h_len = _remove_tokens(hyp, h_len, ignored)
        ref, r_len = _remove_tokens(ref, r_len, ignored)
    dist = _levenshtein(hyp, ref, h_len, r_len)
    if attrs.get('normalized', False):
        dist = dist / r_len.to(dist.dtype).clamp(min=1.0)
    return {'Out': [dist[:, None]],
            'SequenceNum': [device_constant(np.array([b], np.int64),
                                            hyp.device)]}


# ---------------------------------------------------------- sampling

@register('nce', no_grad_out_slots=('SampleLogits', 'SampleLabels'))
def nce(ctx, ins, attrs):
    """Noise-contrastive estimation (nce_op.h): Input [B,D], Weight
    [V,D], Bias [V], Label [B,num_true] -> Cost [B,1], SampleLogits
    [B, num_true + num_neg], SampleLabels (the labels, then the
    negatives drawn for the row).  Samplers as the JAX package writes
    them: 'uniform' over [0, V), 'log_uniform' (Zipf, math/sampler.cc
    LogUniformSampler: k = floor(exp(u log(V+1))) - 1, P(k) in its log1p
    form) and 'custom_dist' (the inverse of the distribution's CDF)."""
    x = ins['Input'][0]
    w = ins['Weight'][0]
    bias = ins['Bias'][0].reshape(-1, 1) if ins.get('Bias') else None
    label = ins['Label'][0].long()
    if label.ndim == 1:
        label = label[:, None]
    b = x.shape[0]
    v = w.shape[0]
    num_true = label.shape[1]
    num_neg = int(attrs.get('num_neg_samples', 10))
    sampler = attrs.get('sampler', 'uniform')
    custom = attrs.get('custom_dist')
    bits, u = _uniform(ctx, attrs, (b, num_neg), x.device)
    if custom is not None and sampler in ('custom_dist', 2):
        dist = np.asarray(custom, np.float32)
        dist = dist / dist.sum(dtype=np.float32)
        cdf = np.cumsum(dist.astype(np.float64))
        neg = torch.searchsorted(
            device_constant(cdf / cdf[-1], x.device), u.double(),
            right=True).clamp(max=v - 1)
        table = device_constant(dist, x.device)

        def p_of(ids):
            return table[ids]
    elif sampler in ('uniform', 0, None):
        neg = (bits * v) >> 24

        def p_of(ids):
            return torch.full(ids.shape, 1.0 / v, dtype=torch.float32,
                              device=ids.device)
    elif sampler in ('log_uniform', 1):
        neg = torch.clamp(torch.floor(torch.exp(u * np.log(v + 1.0))) - 1.0,
                          0, v - 1).long()

        def p_of(ids):
            # log1p form: log((k+2)/(k+1)) rounds to log(1) = 0 in f32
            # for ids near 8M
            return (torch.log1p(1.0 / (ids.to(torch.float32) + 1.0)) /
                    np.log(v + 1.0)).to(torch.float32)
    else:
        raise NotImplementedError(
            'nce: sampler %r is not implemented (uniform | log_uniform | '
            'custom_dist)' % (sampler,))

    def logits_of(ids):
        z = (embedding_lookup(w, ids) * x[:, None, :]).sum(-1)
        if bias is not None:
            z = z + embedding_lookup(bias, ids)[..., 0]
        return z

    # logit - log(num_neg * P(w)): NCE's sampling correction
    z_true = logits_of(label) - torch.log(num_neg * p_of(label))
    z_neg = logits_of(neg) - torch.log(num_neg * p_of(neg))
    cost = (_softplus(-z_true).sum(1) + _softplus(z_neg).sum(1)) / num_true
    return {'Cost': [cost[:, None]],
            'SampleLogits': [torch.cat([z_true, z_neg], 1)],
            'SampleLabels': [torch.cat([label, neg], 1)]}


@register('hierarchical_sigmoid', no_grad_out_slots=('PreOut',))
def hierarchical_sigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the default complete binary tree
    (hierarchical_sigmoid_op.h, math/matrix_bit_code.h SimpleCode: code =
    label + num_classes, node(bit b) = (code >> (b+1)) - 1, bit value
    (code >> b) & 1, path length floor(log2(code))).  X [B,D], W [C-1,D],
    Bias [C-1], Label [B] -> Out [B,1], PreOut [B, L].  Every length is
    integer arithmetic (a float log2 is off at exact powers of two)."""
    x = ins['X'][0]
    w = ins['W'][0]
    bias = ins['Bias'][0].reshape(-1, 1) if ins.get('Bias') else None
    label = ins['Label'][0].reshape(-1).long()
    num_classes = int(attrs['num_classes'])
    max_len = max(2 * num_classes - 1, 2).bit_length() - 1
    code = label + num_classes                                   # [B]
    shifts = torch.arange(max_len, device=x.device)
    length = ((code[:, None] >> (shifts + 1)[None, :]) > 0).sum(1)
    node = (code[:, None] >> (shifts[None, :] + 1)) - 1          # [B, L]
    bit = ((code[:, None] >> shifts[None, :]) & 1).to(x.dtype)
    mask = (shifts[None, :] < length[:, None]).to(x.dtype)
    node = node.clamp(0, w.shape[0] - 1)
    z = (embedding_lookup(w, node) * x[:, None, :]).sum(-1)
    if bias is not None:
        z = z + embedding_lookup(bias, node)[..., 0]
    # sigmoid cross entropy with the path bit as label
    loss = (_softplus(z) - bit * z) * mask
    return {'Out': [loss.sum(1, keepdim=True)], 'PreOut': [z]}


@register('sample_logits', no_grad_out_slots=('Samples', 'Probabilities',
                                              'SampledLabels'))
def sample_logits(ctx, ins, attrs):
    """Sampled softmax (operators/sample_logits_op.cc): each row's true
    labels and `num_samples` log-uniform negatives shared by the batch,
    logits corrected by -log Q; a negative equal to one of the row's
    labels gets -1e20 added (remove_accidental_hits).  Logits [N,K],
    Labels [N,NT] -> SampledLogits [N, NT+S], Samples, Probabilities,
    SampledLabels."""
    logits = ins['Logits'][0]
    labels = ins['Labels'][0].long()
    num_samples = int(attrs.get('num_samples', 10))
    n, k = logits.shape
    nt = labels.shape[1]
    _, u = _uniform(ctx, attrs, (num_samples,), logits.device, salt=0)
    u = 1e-6 + u * (1.0 - 1e-6)
    neg = (torch.exp(u * np.log(k + 1.0)) - 1.0).long().clamp(0, k - 1)
    samples = torch.cat([labels, neg.expand(n, num_samples)], -1)
    # the JAX package's log Q, evaluated in f64: in f32 the difference of
    # the two logs keeps two or three digits for ids near 10^4, which
    # the CPU's and the card's log round differently
    s = samples.to(torch.float64)
    logq = torch.log((torch.log(s + 2.0) - torch.log(s + 1.0)) /
                     np.log(k + 1.0)).to(torch.float32)
    if not attrs.get('uniq', True):
        logq = torch.zeros_like(logq)
    sampled = _take_rows(logits, samples) - logq.to(logits.dtype)
    if attrs.get('remove_accidental_hits', True):
        hit = (samples[:, nt:, None] == labels[:, None, :]).any(-1)
        sampled = torch.cat([sampled[:, :nt], sampled[:, nt:] + torch.where(
            hit, -1e20, 0.0).to(sampled.dtype)], 1)
    return {'SampledLogits': [sampled], 'Samples': [samples],
            'Probabilities': [torch.exp(logq)],
            'SampledLabels': [torch.arange(nt, device=logits.device
                                           ).expand(n, nt)]}


# -------------------------------------------------------- similarity

@register('cos_sim')
def cos_sim(ctx, ins, attrs):
    """cos_sim_op.h: X [B,D], Y [B,D] or [1,D] -> Out [B,1], XNorm,
    YNorm."""
    x = ins['X'][0]
    y = ins['Y'][0]
    xn = torch.sqrt((x * x).sum(1, keepdim=True))
    yn = torch.sqrt((y * y).sum(1, keepdim=True))
    dot = (x * y).sum(1, keepdim=True)
    return {'Out': [dot / (xn * yn).clamp(min=1e-12)], 'XNorm': [xn],
            'YNorm': [yn]}


# ----------------------------------------------------- text matching

_M32 = 0xFFFFFFFF


@register('pyramid_hash', no_grad_out_slots=('DropPos', 'X_Temp_Out'))
def pyramid_hash(ctx, ins, attrs):
    """Text n-gram hash embedding (operators/pyramid_hash_op.cc): every
    n-gram (n = 2..pyramid_layer) of the ids is hashed into
    [0, space_len) and its embedding rows summed at its first position.
    The JAX package's hash, a uint32 multiply-add that wraps mod 2**32
    (h = h * 2654435761 + next * 40503), computed in int64 and masked to
    32 bits at every step, so the rows match its bit for bit."""
    x = ins['X'][0].long()
    w = ins['W'][0]
    space = w.shape[0]
    pyramid = int(attrs.get('pyramid_layer', 2))
    b, t = x.shape
    valid = ins['Mask'][0].to(torch.float32) if ins.get('Mask') else \
        torch.ones((b, t), dtype=torch.float32, device=x.device)
    out = torch.zeros((b, t, w.shape[1]), dtype=w.dtype, device=w.device)
    h = x & _M32
    run = valid
    pos = torch.arange(t, device=x.device)[None, :]
    for n in range(2, pyramid + 1):
        nxt = torch.roll(x, -(n - 1), 1) & _M32
        h = (mul32(h, 2654435761) + mul32(nxt, 40503)) & _M32
        run = run * torch.roll(valid, -(n - 1), 1)
        ok = run * (pos < t - (n - 1)).to(torch.float32)
        out = out + embedding_lookup(w, h % space) * \
            ok[:, :, None].to(w.dtype)
    return {'Out': [out],
            'DropPos': [torch.zeros((b, t), dtype=torch.int32,
                                    device=x.device)],
            'X_Temp_Out': [x]}


@register('filter_by_instag', no_grad_out_slots=('LossWeight', 'IndexMap'))
def filter_by_instag(ctx, ins, attrs):
    """Rows whose tag is in Filter_tag (operators/filter_by_instag_op.cc
    keeps a dynamic row count): shape-stable, the other rows zeroed and
    LossWeight the 0/1 row mask, as in the JAX package."""
    x = ins['Ins'][0]
    tags = ins['Ins_tag'][0].long()
    filt = ins['Filter_tag'][0].long()
    lw = (tags[:, None] == filt[None, :]).any(-1).to(torch.float32)
    out = x * lw.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    idx = torch.arange(x.shape[0], device=x.device)
    return {'Out': [out], 'LossWeight': [lw[:, None]],
            'IndexMap': [torch.stack([idx, idx], -1)]}


@register('var_conv_2d')
def var_conv_2d(ctx, ins, attrs):
    """Per-sample match-matrix convolution (operators/var_conv_2d_op.cc)
    on the dense form: X [B, in_c, H, W] padded to the bucket, Mask
    zeroing the padding before and after the convolution; W [out_c,
    in_c*kh*kw].  An unfold and a product (no cuDNN algorithm choice, so
    the gradient adds in one order at every launch)."""
    x = ins['X'][0]
    w = ins['W'][0]
    out_c = int(attrs.get('output_channel', w.shape[0]))
    kh = int(attrs.get('kernel_h', 3))
    kw = int(attrs.get('kernel_w', 3))
    sh = int(attrs.get('stride_h', 1))
    sw = int(attrs.get('stride_w', 1))
    mask = ins['Mask'][0].to(x.dtype) if ins.get('Mask') else None
    if mask is not None:
        x = x * mask
    b, _, h, wd = x.shape
    cols = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2),
                    stride=(sh, sw))                    # [B, in_c*kh*kw, L]
    oh = (h + 2 * (kh // 2) - kh) // sh + 1
    ow = (wd + 2 * (kw // 2) - kw) // sw + 1
    out = torch.matmul(w.reshape(out_c, -1), cols).reshape(b, out_c, oh, ow)
    if mask is not None and out.shape[2:] == x.shape[2:]:
        out = out * mask
    return {'Out': [out]}


@register('tree_conv')
def tree_conv(ctx, ins, attrs):
    """Tree-based convolution (operators/tree_conv_op.cc, TBCNN, depth-1
    windows): each node aggregates itself and its children with three
    weights mixed by position coefficients eta_t (self) and eta_l / eta_r
    (linear in the sibling index).  NodesVector [B,N,F], EdgeSet [B,E,2]
    (parent, child; negative rows pad), Filter [F,3,H,C] -> Out
    [B, N, H*C].  The child gather and the scatter-add into the parents
    are one-hot products: no atomics."""
    nodes = ins['NodesVector'][0]
    edges = ins['EdgeSet'][0].long()
    w = ins['Filter'][0]
    b, n, _ = nodes.shape
    e = edges.shape[1]
    wt, wl, wr = w[:, 0], w[:, 1], w[:, 2]               # each [F, H, C]
    par, chi = edges[:, :, 0], edges[:, :, 1]
    ok = ((par >= 0) & (chi >= 0)).to(nodes.dtype)
    same = (par[:, :, None] == par[:, None, :]).to(nodes.dtype) * \
        ok[:, :, None] * ok[:, None, :]
    ar = torch.arange(e, device=nodes.device)
    order = (same * (ar[None, None, :] < ar[None, :, None]).to(
        nodes.dtype)).sum(-1)
    count = same.sum(-1)
    eta_r = torch.where(count > 1, order / (count - 1).clamp(min=1.0),
                        torch.full_like(count, 0.5))
    eta_l = 1.0 - eta_r
    cvec = torch.matmul(_one_hot(chi.clamp(min=0), n, nodes.dtype), nodes)
    contrib = (torch.einsum('bef,fhc->behc', cvec, wl) *
               eta_l[:, :, None, None] +
               torch.einsum('bef,fhc->behc', cvec, wr) *
               eta_r[:, :, None, None]) * ok[:, :, None, None]
    agg = torch.einsum('ben,behc->bnhc',
                       _one_hot(par.clamp(min=0), n, nodes.dtype), contrib)
    out = torch.tanh(torch.einsum('bnf,fhc->bnhc', nodes, wt) + agg)
    return {'Out': [out.reshape(b, n, -1)]}
