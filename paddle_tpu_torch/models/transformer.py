"""Transformer-base encoder-decoder (WMT16 en-de), built through the port's
layers exactly as `paddle_tpu/models/transformer.py` builds it, so both
packages emit the same Program op for op (equal var names give equal
dropout masks). The decoder adds causal self-attention and cross-attention
over the encoder output, each with a [b, s] key bias from its padding
mask. Three programs share one set of parameter names, so a trained scope
drives all of them: `build_transformer` (training, or `is_test` logits),
`build_transformer_encode` (the encoder and each decoder layer's
cross-attention K/V projected once per source batch) and
`build_transformer_decode_step` (one is_test decoder pass over the target
prefix with those K/V fed, for incremental decode)."""

from __future__ import annotations

import math

import numpy as np

from .. import layers, profiler
from ..initializer import Constant, NumpyArrayInitializer, TruncatedNormal
from ..param_attr import ParamAttr
from .bert import tied_logits

__all__ = ["TransformerConfig", "build_transformer",
           "build_transformer_encode", "build_transformer_decode_step",
           "transformer_flops_per_trg_token"]


class TransformerConfig:
    """The JAX package's config. `attn_layout` ("bshd", the default, or
    "bhsd") is an argument here: the JAX config reads it from the
    environment variable PADDLE_TPU_ATTN_LAYOUT, which the port does not
    read; with that variable unset the two are equal."""

    def __init__(
        self,
        src_vocab=30000,
        trg_vocab=30000,
        d_model=512,
        n_heads=8,
        d_ff=2048,
        n_layers=6,
        max_len=256,
        dropout=0.1,
        use_flash_attention=True,
        weight_sharing=True,
        attn_layout="bshd",
    ):
        self.src_vocab = src_vocab
        self.trg_vocab = trg_vocab
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.n_layers = n_layers
        self.max_len = max_len
        self.dropout = dropout
        self.use_flash_attention = use_flash_attention
        # one embedding table for source and target, reused transposed as
        # the output projection (no [d_model, trg_vocab] parameter)
        if weight_sharing and src_vocab != trg_vocab:
            raise ValueError(
                "weight_sharing requires src_vocab == trg_vocab "
                f"(got {src_vocab} vs {trg_vocab})"
            )
        self.weight_sharing = weight_sharing
        if attn_layout not in ("bshd", "bhsd"):
            raise ValueError(f"attn_layout must be 'bshd' or 'bhsd', got {attn_layout!r}")
        self.attn_layout = attn_layout

    @staticmethod
    def base():
        return TransformerConfig()

    @staticmethod
    def tiny():
        return TransformerConfig(
            src_vocab=200, trg_vocab=200, d_model=32, n_heads=4, d_ff=64,
            n_layers=2, max_len=32,
        )


def _fc(x, size, name, act=None):
    return layers.fc(
        x,
        size,
        num_flatten_dims=2,
        act=act,
        param_attr=ParamAttr(name=name + ".w_0",
                             initializer=TruncatedNormal(0.0, 0.02)),
        bias_attr=ParamAttr(name=name + ".b_0", initializer=Constant(0.0)),
    )


def _mha(q_in, kv_in, bias, cfg, name, is_test, key_bias=None, causal=False,
         cached_kv=None):
    """Multi-head attention; `cached_kv` (k, v): this layer's projections of
    the encoder output, fed instead of projected here (counted under the
    profiler's `cross_kv_reuse`)."""
    b, sq = q_in.shape[0], q_in.shape[1]
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    q = _fc(q_in, cfg.d_model, name + ".q")
    if cached_kv is not None:
        k, v = cached_kv
        profiler.bump_counter("cross_kv_reuse")
    else:
        k = _fc(kv_in, cfg.d_model, name + ".k")
        v = _fc(kv_in, cfg.d_model, name + ".v")
    sk = k.shape[1]

    if cfg.use_flash_attention:
        layout = cfg.attn_layout
        if layout == "bshd":  # the head-split reshape, no transposes
            qh = layers.reshape(q, [b, sq, nh, dh])
            kh = layers.reshape(k, [b, sk, nh, dh])
            vh = layers.reshape(v, [b, sk, nh, dh])
        else:
            qh = layers.transpose(
                layers.reshape(q, [b, sq, nh, dh]), [0, 2, 1, 3])
            kh = layers.transpose(
                layers.reshape(k, [b, sk, nh, dh]), [0, 2, 1, 3])
            vh = layers.transpose(
                layers.reshape(v, [b, sk, nh, dh]), [0, 2, 1, 3])
        out = layers.fused_multihead_attention(
            qh, kh, vh, key_bias=key_bias, causal=causal,
            sm_scale=1.0 / math.sqrt(dh),
            attn_dropout=cfg.dropout if not is_test else 0.0,
            is_test=is_test, layout=layout,
        )
        if layout == "bshd":
            merged = layers.reshape(out, [b, sq, cfg.d_model])
        else:
            merged = layers.reshape(
                layers.transpose(out, [0, 2, 1, 3]), [b, sq, cfg.d_model])
    else:
        def split(t, s):
            return layers.transpose(
                layers.reshape(t, [b, s, nh, dh]), [0, 2, 1, 3]
            )

        qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
        scores = layers.matmul(qh, kh, transpose_y=True,
                               alpha=1.0 / math.sqrt(dh))
        if bias is not None:
            scores = layers.elementwise_add(scores, bias)
        probs = layers.softmax(scores)
        if cfg.dropout and not is_test:
            probs = layers.dropout(probs, cfg.dropout,
                                   dropout_implementation="upscale_in_train")
        out = layers.matmul(probs, vh)
        merged = layers.reshape(
            layers.transpose(out, [0, 2, 1, 3]), [b, sq, cfg.d_model]
        )
    return _fc(merged, cfg.d_model, name + ".out")


def _ffn(x, cfg, name, is_test):
    h = _fc(x, cfg.d_ff, name + ".fc1", act="relu")
    if cfg.dropout and not is_test:
        h = layers.dropout(h, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    return _fc(h, cfg.d_model, name + ".fc2")


def _encoder_stack(enc, src_bias, src_key_bias, cfg, is_test):
    for i in range(cfg.n_layers):
        name = f"enc{i}"
        attn = _mha(enc, enc, src_bias, cfg, name + ".self", is_test,
                    key_bias=src_key_bias)
        enc = _post(attn, enc, cfg, name + ".ln1", is_test)
        ff = _ffn(enc, cfg, name + ".ffn", is_test)
        enc = _post(ff, enc, cfg, name + ".ln2", is_test)
    return enc


def _decoder_stack(dec, enc, trg_bias, src_bias, trg_key_bias, src_key_bias,
                   cfg, is_test, cross_kv=None):
    """cross_kv: optional per-layer (k, v) projections of the encoder
    output (build_transformer_encode's), used instead of projecting enc."""
    for i in range(cfg.n_layers):
        name = f"dec{i}"
        attn = _mha(dec, dec, trg_bias, cfg, name + ".self", is_test,
                    key_bias=trg_key_bias, causal=True)
        dec = _post(attn, dec, cfg, name + ".ln1", is_test)
        cross = _mha(dec, enc, src_bias, cfg, name + ".cross", is_test,
                     key_bias=src_key_bias,
                     cached_kv=None if cross_kv is None else cross_kv[i])
        dec = _post(cross, dec, cfg, name + ".ln2", is_test)
        ff = _ffn(dec, cfg, name + ".ffn", is_test)
        dec = _post(ff, dec, cfg, name + ".ln3", is_test)
    return dec


def _post(x, residual, cfg, name, is_test):
    """dropout(x) + residual, then a LayerNorm."""
    y = x
    if cfg.dropout and not is_test:
        y = layers.dropout(y, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    return layers.layer_norm(
        layers.elementwise_add(residual, y), begin_norm_axis=2, name=name
    )


def _position_table(cfg):
    """The sinusoid table [max_len, d_model]: sin on even, cos on odd dims."""
    pos = np.arange(cfg.max_len)[:, None]
    dim = np.arange(cfg.d_model)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / cfg.d_model)
    return np.where(dim % 2 == 0, np.sin(angle), np.cos(angle)).astype("float32")


def _embed(ids, vocab, cfg, name, pos_table_name, table_name=None):
    """Token embedding times sqrt(d_model) plus the position embedding,
    a frozen parameter filled from the sinusoid table -> (sum, the name
    of the position-id feed)."""
    b, s = ids.shape
    emb = layers.embedding(
        ids, (vocab, cfg.d_model),
        param_attr=ParamAttr(name=table_name or name,
                             initializer=TruncatedNormal(0.0, 0.02)),
    )
    emb = layers.scale(emb, scale=math.sqrt(cfg.d_model))
    pos_ids = layers.data(
        name + "_posids_" + str(s), [b, s], dtype="int64",
        append_batch_size=False,
    )
    pos_emb = layers.embedding(
        pos_ids, (cfg.max_len, cfg.d_model),
        param_attr=ParamAttr(
            name=pos_table_name,
            initializer=NumpyArrayInitializer(_position_table(cfg)),
            trainable=False,
        ),
    )
    return layers.elementwise_add(emb, pos_emb), pos_ids.name


def _causal_bias(trg_mask, b, trg_len):
    """The unfused decoder's [b, 1, t, t] bias: -1e4 on padded keys and
    past the diagonal (an `assign_value` of the triangle)."""
    trg_pad = layers.scale(
        layers.reshape(trg_mask, [b, 1, 1, trg_len]),
        scale=1e4, bias=-1.0, bias_after_scale=False,
    )
    causal_np = np.triu(np.full((trg_len, trg_len), -1e4, dtype="float32"), k=1)
    causal = layers.assign(causal_np.reshape(1, 1, trg_len, trg_len))
    causal.stop_gradient = True
    return layers.elementwise_add(trg_pad, causal)


def _logits(dec, cfg, trg_table):
    if cfg.weight_sharing:
        return tied_logits(dec, trg_table, cfg.trg_vocab, "proj.b")
    return _fc(dec, cfg.trg_vocab, "proj")


def build_transformer(cfg, batch_size, src_len, trg_len, is_test=False):
    """-> a dict of handles (feeds, src_pos_name, trg_pos_name, logits,
    loss). Feeds: src_ids, trg_ids, lbl_ids [b, t] int64; src_mask,
    trg_mask [b, t] float32; the two position-id feeds."""
    b = batch_size
    src_ids = layers.data("src_ids", [b, src_len], dtype="int64",
                          append_batch_size=False)
    trg_ids = layers.data("trg_ids", [b, trg_len], dtype="int64",
                          append_batch_size=False)
    lbl_ids = layers.data("lbl_ids", [b, trg_len], dtype="int64",
                          append_batch_size=False)
    src_mask = layers.data("src_mask", [b, src_len], dtype="float32",
                           append_batch_size=False)
    trg_mask = layers.data("trg_mask", [b, trg_len], dtype="float32",
                           append_batch_size=False)

    # padding biases for the encoder and the cross attention; padding and
    # causal for the decoder's self-attention (in the kernel when fused)
    if cfg.use_flash_attention:
        src_bias = trg_bias = None
        src_key_bias = layers.scale(src_mask, scale=1e4, bias=-1.0,
                                    bias_after_scale=False)
        trg_key_bias = layers.scale(trg_mask, scale=1e4, bias=-1.0,
                                    bias_after_scale=False)
    else:
        src_key_bias = trg_key_bias = None
        src_bias = layers.scale(
            layers.reshape(src_mask, [b, 1, 1, src_len]),
            scale=1e4, bias=-1.0, bias_after_scale=False,
        )
        trg_bias = _causal_bias(trg_mask, b, trg_len)

    src_table = "shared_emb" if cfg.weight_sharing else "src_emb.table"
    trg_table = "shared_emb" if cfg.weight_sharing else "trg_emb.table"
    enc, src_pos_name = _embed(src_ids, cfg.src_vocab, cfg, "src_emb",
                               "pos_enc_src", src_table)
    if cfg.dropout and not is_test:
        enc = layers.dropout(enc, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    enc = _encoder_stack(enc, src_bias, src_key_bias, cfg, is_test)

    dec, trg_pos_name = _embed(trg_ids, cfg.trg_vocab, cfg, "trg_emb",
                               "pos_enc_trg", trg_table)
    if cfg.dropout and not is_test:
        dec = layers.dropout(dec, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    dec = _decoder_stack(dec, enc, trg_bias, src_bias, trg_key_bias,
                         src_key_bias, cfg, is_test)

    logits = _logits(dec, cfg, trg_table)
    labels3 = layers.reshape(lbl_ids, [b, trg_len, 1])
    per_tok = layers.softmax_with_cross_entropy(logits, labels3)
    per_tok = layers.reshape(per_tok, [b, trg_len])
    masked = layers.elementwise_mul(per_tok, trg_mask)
    denom = layers.elementwise_add(
        layers.reduce_sum(trg_mask), layers.fill_constant([1], "float32", 1e-6)
    )
    loss = layers.elementwise_div(layers.reduce_sum(masked), denom)
    return {
        "feeds": ["src_ids", "trg_ids", "lbl_ids", "src_mask", "trg_mask",
                  src_pos_name, trg_pos_name],
        "src_pos_name": src_pos_name,
        "trg_pos_name": trg_pos_name,
        "logits": logits,
        "loss": loss,
    }


def _src_biases(src_mask, b, src_len, cfg):
    if cfg.use_flash_attention:
        src_bias = None
        src_key_bias = layers.scale(src_mask, scale=1e4, bias=-1.0,
                                    bias_after_scale=False)
    else:
        src_key_bias = None
        src_bias = layers.scale(
            layers.reshape(src_mask, [b, 1, 1, src_len]),
            scale=1e4, bias=-1.0, bias_after_scale=False,
        )
    return src_bias, src_key_bias


def build_transformer_encode(cfg, batch_size, src_len):
    """The encode program of incremental decode: the encoder stack and each
    decoder layer's cross-attention K/V projection of its output, run once
    per source batch -> handles (feeds, src_pos_name, enc, cross_kv_names:
    [(k name, v name)] a layer, to fetch and feed to the decode step)."""
    b = batch_size
    src_ids = layers.data("src_ids", [b, src_len], dtype="int64",
                          append_batch_size=False)
    src_mask = layers.data("src_mask", [b, src_len], dtype="float32",
                           append_batch_size=False)
    src_bias, src_key_bias = _src_biases(src_mask, b, src_len, cfg)
    src_table = "shared_emb" if cfg.weight_sharing else "src_emb.table"
    enc, src_pos_name = _embed(src_ids, cfg.src_vocab, cfg, "src_emb",
                               "pos_enc_src", src_table)
    enc = _encoder_stack(enc, src_bias, src_key_bias, cfg, is_test=True)
    cross_kv = [
        (_fc(enc, cfg.d_model, f"dec{i}.cross.k").name,
         _fc(enc, cfg.d_model, f"dec{i}.cross.v").name)
        for i in range(cfg.n_layers)
    ]
    return {
        "feeds": ["src_ids", "src_mask", src_pos_name],
        "src_pos_name": src_pos_name,
        "enc": enc,
        "cross_kv_names": cross_kv,
    }


def build_transformer_decode_step(cfg, batch_size, src_len, trg_len,
                                  reuse_cross_kv=True):
    """One is_test decoder pass over the current target prefix -> handles
    (feeds, trg_pos_name, logits). With `reuse_cross_kv` (the default)
    each layer's cross-attention K/V are feeds `dec{i}.cross.k_cached` /
    `.v_cached` [b, src_len, d_model] from the encode program: 4 ops a
    layer fewer than projecting the fed encoder output `enc_out` again,
    which reuse_cross_kv=False builds."""
    b = batch_size
    trg_ids = layers.data("trg_ids", [b, trg_len], dtype="int64",
                          append_batch_size=False)
    src_mask = layers.data("src_mask", [b, src_len], dtype="float32",
                           append_batch_size=False)
    trg_mask = layers.data("trg_mask", [b, trg_len], dtype="float32",
                           append_batch_size=False)
    src_bias, src_key_bias = _src_biases(src_mask, b, src_len, cfg)
    if cfg.use_flash_attention:
        trg_bias = None
        trg_key_bias = layers.scale(trg_mask, scale=1e4, bias=-1.0,
                                    bias_after_scale=False)
    else:
        trg_key_bias = None
        trg_bias = _causal_bias(trg_mask, b, trg_len)

    feeds = ["trg_ids", "src_mask", "trg_mask"]
    cross_kv = None
    enc = None
    if reuse_cross_kv:
        cross_kv = []
        for i in range(cfg.n_layers):
            k = layers.data(f"dec{i}.cross.k_cached",
                            [b, src_len, cfg.d_model],
                            append_batch_size=False)
            v = layers.data(f"dec{i}.cross.v_cached",
                            [b, src_len, cfg.d_model],
                            append_batch_size=False)
            cross_kv.append((k, v))
            feeds += [k.name, v.name]
    else:
        enc = layers.data("enc_out", [b, src_len, cfg.d_model],
                          append_batch_size=False)
        feeds.append("enc_out")

    trg_table = "shared_emb" if cfg.weight_sharing else "trg_emb.table"
    dec, trg_pos_name = _embed(trg_ids, cfg.trg_vocab, cfg, "trg_emb",
                               "pos_enc_trg", trg_table)
    feeds.append(trg_pos_name)
    dec = _decoder_stack(dec, enc, trg_bias, src_bias, trg_key_bias,
                         src_key_bias, cfg, is_test=True,
                         cross_kv=cross_kv)
    return {
        "feeds": feeds,
        "trg_pos_name": trg_pos_name,
        "logits": _logits(dec, cfg, trg_table),
    }


def transformer_flops_per_trg_token(cfg, s_src, s_trg) -> float:
    """Training (forward and backward, 3x the forward) matmul FLOPs per
    target token. Attention's score and context products count the full
    key length; the encoder's tokens ride the same batch rows, so their
    cost folds into each target token (s_src == s_trg in the benchmark)."""
    d, dff = cfg.d_model, cfg.d_ff
    enc = cfg.n_layers * (2 * 4 * d * d + 2 * 2 * s_src * d
                          + 2 * 2 * d * dff)
    dec = cfg.n_layers * (
        2 * 4 * d * d + 2 * 2 * s_trg * d      # self attention
        + 2 * 4 * d * d + 2 * 2 * s_src * d    # cross attention
        + 2 * 2 * d * dff
    )
    logits = 2 * d * cfg.trg_vocab
    return 3 * (enc + dec + logits)
