"""Beam-search decoding: `beam_search_step`, one beam expansion in numpy,
and `BeamSearchDecoder`, a host loop over a one-step decoder Program run
by the Executor (the step program stays on the card; the host reorders
beams). The port's own copy of `paddle_tpu/decoding.py` (numpy only), with
the same results on the same inputs."""

from __future__ import annotations

import numpy as np

__all__ = ["beam_search_step", "BeamSearchDecoder"]

NEG_INF = -1e9


def beam_search_step(log_probs, scores, finished, beam_size, eos_id,
                     length_penalty=0.0, step=1, lengths=None):
    """One beam expansion.

    log_probs: [b, k, V] next-token log-probabilities; scores: [b, k]
    running sequence scores; finished: [b, k] bool; lengths: [b, k]
    hypothesis lengths (frozen when finished), needed for a non-zero GNMT
    length_penalty, where ranking divides each candidate's score by
    ((5 + len) / 6) ^ alpha with the candidate's own length.
    Returns (next_tokens [b, k], beam_idx, new_scores, new_finished) and,
    when `lengths` was given, new_lengths as a fifth element. Finished
    beams keep their score and emit eos again; an eos_id outside [0, V)
    decodes without an end token.
    """
    log_probs = np.asarray(log_probs)
    scores = np.asarray(scores)
    finished = np.asarray(finished)
    b, k, v = log_probs.shape

    # finished beams: only eos continues, at no cost
    cont = np.where(finished[:, :, None], NEG_INF, log_probs)
    if 0 <= eos_id < v:
        cont[:, :, eos_id] = np.where(finished, 0.0, log_probs[:, :, eos_id])
    total = scores[:, :, None] + cont  # [b, k, V]
    if length_penalty > 0.0:
        if lengths is None:
            raise ValueError(
                "length_penalty needs per-beam `lengths` (frozen at "
                "finish) — a step-constant penalty cannot reorder beams"
            )
        cand_len = np.where(finished, np.asarray(lengths), step)
        lp = ((5.0 + cand_len) / 6.0) ** length_penalty  # [b, k]
        ranked = total / lp[:, :, None]
    else:
        ranked = total

    flat = ranked.reshape(b, k * v)
    top = np.argsort(-flat, axis=1)[:, :beam_size]  # [b, beam_size]
    beam_idx = top // v
    next_tokens = top % v
    new_scores = np.take_along_axis(total.reshape(b, k * v), top, axis=1)
    prev_finished = np.take_along_axis(finished, beam_idx, axis=1)
    new_finished = prev_finished | (
        (next_tokens == eos_id) if 0 <= eos_id < v
        else np.zeros_like(prev_finished)
    )
    if lengths is None:
        return next_tokens, beam_idx, new_scores, new_finished
    new_lengths = np.where(
        prev_finished,
        np.take_along_axis(np.asarray(lengths), beam_idx, axis=1),
        step,
    )
    return next_tokens, beam_idx, new_scores, new_finished, new_lengths


class BeamSearchDecoder:
    """Host-driven beam search over a one-step decoder program.

    The step program feeds `token_feed` [b*k, 1] int64 (the last token) and
    the entries of `state_feeds` (each [b*k, ...]); it fetches
    `logits_fetch` [b*k, V] and `state_fetches` (the updated state, in the
    order of state_feeds).
    """

    def __init__(self, executor, step_program, token_feed, state_feeds,
                 logits_fetch, state_fetches, beam_size=4, max_len=16,
                 bos_id=1, eos_id=2, length_penalty=0.0, scope=None,
                 constant_feeds=()):
        """constant_feeds: per-sequence feeds that never change across
        steps (an attention decoder's encoder states): tiled to the beams
        once and fed again every step, never fetched or reordered (equal
        across a sequence's beams)."""
        self.exe = executor
        self.program = step_program
        self.token_feed = token_feed
        self.state_feeds = list(state_feeds)
        self.logits_fetch = logits_fetch
        self.state_fetches = list(state_fetches)
        self.constant_feeds = list(constant_feeds)
        self.k = beam_size
        self.max_len = max_len
        self.bos = bos_id
        self.eos = eos_id
        self.length_penalty = length_penalty
        self.scope = scope

    def __call__(self, init_state: dict):
        """init_state: {feed name: [b, ...]}, one beam per sequence (tiled
        here) -> (tokens [b, k, max_len], scores [b, k]), best first."""
        b = next(iter(init_state.values())).shape[0]
        k = self.k
        state = {
            n: np.repeat(np.asarray(v), k, axis=0)  # [b*k, ...]
            for n, v in init_state.items()
            if n in self.state_feeds
        }
        const = {
            n: np.repeat(np.asarray(init_state[n]), k, axis=0)
            for n in self.constant_feeds
        }
        tokens = np.full((b, k), self.bos, np.int64)
        seqs = np.zeros((b, k, self.max_len), np.int64)
        scores = np.full((b, k), NEG_INF, np.float32)
        scores[:, 0] = 0.0  # all beams start equal: keep one alive
        finished = np.zeros((b, k), bool)
        lengths = np.zeros((b, k), np.int64)

        for t in range(self.max_len):
            feed = {self.token_feed: tokens.reshape(b * k, 1)}
            feed.update({n: state[n] for n in self.state_feeds})
            feed.update(const)
            outs = self.exe.run(
                self.program, feed=feed,
                fetch_list=[self.logits_fetch] + self.state_fetches,
                scope=self.scope,
            )
            logits = np.asarray(outs[0]).reshape(b, k, -1)
            logp = _log_softmax(logits)
            tokens, beam_idx, scores, finished, lengths = beam_search_step(
                logp, scores, finished, k, self.eos,
                self.length_penalty, step=t + 1, lengths=lengths,
            )
            # reorder histories and states by the chosen parent beams
            seqs = np.take_along_axis(seqs, beam_idx[:, :, None], axis=1)
            seqs[:, :, t] = tokens
            flat_idx = (np.arange(b)[:, None] * k + beam_idx).reshape(-1)
            for i, n in enumerate(self.state_fetches):
                new_v = np.asarray(outs[1 + i])
                state[self.state_feeds[i]] = new_v[flat_idx]
            if finished.all():
                break

        if self.length_penalty > 0.0:
            lp = ((5.0 + np.maximum(lengths, 1)) / 6.0) ** self.length_penalty
            order = np.argsort(-(scores / lp), axis=1)
        else:
            order = np.argsort(-scores, axis=1)
        seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
        return seqs, scores


def _log_softmax(x):
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(axis=-1, keepdims=True))
