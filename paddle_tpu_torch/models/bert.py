"""BERT encoder and pretraining heads, built through the port's layers
exactly as `paddle_tpu/models/bert.py` builds them, so both packages emit
the same Program op for op (equal var names are what give equal dropout
masks). The config's switches are the JAX package's: the fused attention
op in the bshd layout (no head transposes) or the bhsd layout (head
transposes around it), or unfused attention (`use_flash_attention=False`:
matmul, bias, softmax, dropout, matmul); separate q/k/v projections or
one fused [h, 3h] projection and a split (`fused_qkv`); the MLM projection
tied to the word embedding or a separate `mlm.out` fc
(`tie_mlm_weights`). The heads: masked-LM over gathered positions
(`max_preds`) or over every position, and, unless `mlm_only`, the
next-sentence head on the first token. The JAX package's environment
switches PADDLE_TPU_FUSED_QKV / PADDLE_TPU_ATTN_LAYOUT (TPU A/B knobs) are
not read: with them unset the defaults are equal. `recompute` puts each
encoder layer in a `recompute_scope(i)`, for optimizer.RecomputeOptimizer;
pipeline stages raise (ROADMAP Queue 1, item 9).

The tensor-parallel PartitionSpec annotations of the JAX model are
recorded on the Program (`_sharding_specs`, as tuples of axis names): on a
mesh whose `model` axis is larger than 1 they run as Megatron tensor
parallelism (parallel/tensor_parallel.py)."""

from __future__ import annotations

import contextlib
import math

from .. import layers
from ..framework import default_main_program, recompute_scope
from ..initializer import Constant, TruncatedNormal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "bert_encoder", "build_bert_pretrain", "bert_flops_per_token"]


class BertConfig:
    def __init__(
        self,
        vocab_size=30522,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position=512,
        type_vocab_size=2,
        hidden_dropout=0.1,
        attention_dropout=0.1,
        initializer_range=0.02,
        use_flash_attention=True,
        recompute=False,
        tie_mlm_weights=True,
        fused_qkv=None,
        attn_layout=None,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.use_flash_attention = use_flash_attention
        self.recompute = recompute
        self.tie_mlm_weights = tie_mlm_weights
        self.fused_qkv = bool(fused_qkv)
        if (attn_layout or "bshd") not in ("bshd", "bhsd"):
            raise ValueError(f"attn_layout must be 'bshd' or 'bhsd', got {attn_layout!r}")
        self.attn_layout = attn_layout or "bshd"

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        """for tests / dry runs"""
        return BertConfig(
            vocab_size=128,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position=64,
        )


def _record_spec(name, spec):
    default_main_program()._sharding_specs[name] = tuple(spec)


def _fc(x, size, name, cfg, act=None, num_flatten_dims=2, tp_spec=None,
        bias_tp=None):
    init = TruncatedNormal(0.0, cfg.initializer_range)
    out = layers.fc(
        x,
        size,
        num_flatten_dims=num_flatten_dims,
        act=act,
        param_attr=ParamAttr(name=name + ".w_0", initializer=init),
        bias_attr=ParamAttr(name=name + ".b_0", initializer=Constant(0.0)),
    )
    if tp_spec is not None:
        _record_spec(name + ".w_0", tp_spec)
        if bias_tp is not None:
            _record_spec(name + ".b_0", bias_tp)
    return out


def _attention(x, attn_bias, cfg, name, is_test):
    """Multi-head self-attention; qkv column-parallel, output row-parallel."""
    b, s, h = x.shape
    nh = cfg.num_heads
    dh = cfg.hidden_size // nh
    if cfg.fused_qkv:
        qkv = _fc(x, 3 * cfg.hidden_size, name + ".qkv", cfg, tp_spec=(None, "tp"),
                  bias_tp=("tp",))
        q, k, v = layers.split(qkv, 3, dim=2)
    else:
        q, k, v = (_fc(x, cfg.hidden_size, name + part, cfg, tp_spec=(None, "tp"),
                       bias_tp=("tp",)) for part in (".q", ".k", ".v"))

    def heads(t):  # [b, nh, s, dh]
        return layers.transpose(layers.reshape(t, [b, s, nh, dh]), [0, 2, 1, 3])

    if cfg.use_flash_attention:
        # bshd: the fused op reads the head-split reshapes, no transposes
        layout = cfg.attn_layout
        if layout == "bshd":
            qh, kh, vh = (layers.reshape(t, [b, s, nh, dh]) for t in (q, k, v))
        else:
            qh, kh, vh = (heads(t) for t in (q, k, v))
        ctxv = layers.fused_multihead_attention(
            qh, kh, vh, key_bias=attn_bias, sm_scale=1.0 / math.sqrt(dh),
            attn_dropout=cfg.attention_dropout if not is_test else 0.0,
            is_test=is_test, layout=layout,
        )
        if layout == "bshd":
            merged = layers.reshape(ctxv, [b, s, h])
        else:
            merged = layers.reshape(layers.transpose(ctxv, [0, 2, 1, 3]), [b, s, h])
    else:
        qh, kh, vh = (heads(t) for t in (q, k, v))
        scores = layers.matmul(qh, kh, transpose_y=True, alpha=1.0 / math.sqrt(dh))
        if attn_bias is not None:
            scores = layers.elementwise_add(scores, attn_bias)
        probs = layers.softmax(scores)
        if cfg.attention_dropout and not is_test:
            probs = layers.dropout(probs, cfg.attention_dropout, is_test=is_test,
                                   dropout_implementation="upscale_in_train")
        ctxv = layers.matmul(probs, vh)  # [b, nh, s, dh]
        merged = layers.reshape(layers.transpose(ctxv, [0, 2, 1, 3]), [b, s, h])
    return _fc(merged, cfg.hidden_size, name + ".out", cfg, tp_spec=("tp", None))


def _dropout(x, cfg, is_test):
    if cfg.hidden_dropout and not is_test:
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return x


def _encoder_layer(x, attn_bias, cfg, name, is_test):
    attn = _dropout(_attention(x, attn_bias, cfg, name + ".attn", is_test), cfg, is_test)
    x = layers.layer_norm(
        layers.elementwise_add(x, attn), begin_norm_axis=2,
        name=name + ".ln1",
    )
    ffn1 = _fc(x, cfg.intermediate_size, name + ".ffn1", cfg,
               act={"type": "gelu", "approximate": True},
               tp_spec=(None, "tp"), bias_tp=("tp",))
    ffn2 = _dropout(_fc(ffn1, cfg.hidden_size, name + ".ffn2", cfg,
                        tp_spec=("tp", None)), cfg, is_test)
    return layers.layer_norm(
        layers.elementwise_add(x, ffn2), begin_norm_axis=2,
        name=name + ".ln2",
    )


def bert_encoder(input_ids, segment_ids, position_ids, input_mask, cfg,
                 is_test=False, pp_stages=1):
    """Final hidden states [b, s, h]; with is_test=False, hidden and
    attention dropout as the config sets them; with cfg.recompute each
    layer one recompute segment. Pipeline stages are not ported and
    raise."""
    if pp_stages > 1:
        raise NotImplementedError(
            "pp_stages > 1 needs the pipeline executor, which is not ported yet "
            "(ROADMAP Queue 1, item 9, parallelism)")
    init = TruncatedNormal(0.0, cfg.initializer_range)
    x, attn_bias = _bert_embedding(
        input_ids, segment_ids, position_ids, input_mask, cfg, is_test, init)
    for i in range(cfg.num_layers):
        # one recompute segment a layer under RecomputeOptimizer
        with recompute_scope(i) if cfg.recompute else contextlib.nullcontext():
            x = _encoder_layer(x, attn_bias, cfg, f"bert.layer{i}", is_test)
    return x


def _bert_embedding(input_ids, segment_ids, position_ids, input_mask, cfg, is_test,
                    init):
    word_emb = layers.embedding(
        input_ids, (cfg.vocab_size, cfg.hidden_size),
        param_attr=ParamAttr(name="bert.word_emb", initializer=init),
    )
    pos_emb = layers.embedding(
        position_ids, (cfg.max_position, cfg.hidden_size),
        param_attr=ParamAttr(name="bert.pos_emb", initializer=init),
    )
    seg_emb = layers.embedding(
        segment_ids, (cfg.type_vocab_size, cfg.hidden_size),
        param_attr=ParamAttr(name="bert.seg_emb", initializer=init),
    )
    emb = layers.elementwise_add(
        layers.elementwise_add(word_emb, pos_emb), seg_emb
    )
    emb = _dropout(layers.layer_norm(emb, begin_norm_axis=2, name="bert.emb_ln"),
                   cfg, is_test)
    # additive key bias from the mask: (mask - 1) * 1e4, i.e. 0 keep and
    # -1e4 drop; [b, s] for the fused op, [b, 1, 1, s] for the scores
    if not cfg.use_flash_attention:
        b, s = input_ids.shape[0], input_ids.shape[1]
        input_mask = layers.reshape(input_mask, [b, 1, 1, s])
    attn_bias = layers.scale(input_mask, scale=1e4, bias=-1.0,
                             bias_after_scale=False)
    return emb, attn_bias


def tied_logits(x, table_name, vocab_size, bias_name):
    """logits = x @ table^T + b with an existing embedding parameter as the
    table: no separate [h, V] parameter or optimizer state."""
    table = default_main_program().global_block().var(table_name)
    logits = layers.matmul(x, table, transpose_y=True)
    helper = LayerHelper(bias_name.replace(".", "_"))
    bias = helper.create_parameter(ParamAttr(name=bias_name), [vocab_size],
                                   dtype="float32", is_bias=True)
    return layers.elementwise_add(logits, bias)


def _mlm_logits(trans, cfg, num_flatten_dims):
    """The vocab projection: tied to the word embedding (the default), or
    a separate `mlm.out` fc."""
    if cfg.tie_mlm_weights:
        return tied_logits(trans, "bert.word_emb", cfg.vocab_size, "mlm.out_b")
    return _fc(trans, cfg.vocab_size, "mlm.out", cfg, num_flatten_dims=num_flatten_dims,
               tp_spec=(None, "tp"), bias_tp=("tp",))


def build_bert_pretrain(cfg, batch_size, seq_len, is_test=False, mlm_only=False,
                        max_preds=None, pp_stages=1):
    """Declares the feeds and the pretraining loss -> a dict of handles
    (feeds, hidden, logits, mlm_loss, loss, and nsp_loss unless mlm_only).
    Ids are [b, s] int64, the mask and weights float32.

    With `max_preds` the masked-LM head scores only the masked positions:
    feed `mask_pos` [b, max_preds] int64 positions in [0, s) per row and
    `mask_label` / `mask_weight` [b, max_preds]; the gather is flat over
    [b*s, h], with row offsets from an exclusive cumsum of a batch-sized
    ones column. With max_preds=None it scores every position, and
    `mask_label` / `mask_weight` are [b, s]. Unless `mlm_only`, the
    next-sentence head takes the first token's hidden state through a tanh
    pooler and a 2-way fc (feed `nsp_label` [b, 1] int64), and the loss is
    the sum of both means."""
    data = layers.data
    input_ids = data("src_ids", [batch_size, seq_len], dtype="int64",
                     append_batch_size=False)
    segment_ids = data("sent_ids", [batch_size, seq_len], dtype="int64",
                       append_batch_size=False)
    position_ids = data("pos_ids", [batch_size, seq_len], dtype="int64",
                        append_batch_size=False)
    input_mask = data("input_mask", [batch_size, seq_len], dtype="float32",
                      append_batch_size=False)
    lbl_shape = [batch_size, max_preds] if max_preds else [batch_size, seq_len]
    mlm_labels = data("mask_label", lbl_shape, dtype="int64", append_batch_size=False)
    mlm_weights = data("mask_weight", lbl_shape, dtype="float32",
                       append_batch_size=False)
    if max_preds:
        mask_pos = data("mask_pos", [batch_size, max_preds], dtype="int64",
                        append_batch_size=False)

    hidden = bert_encoder(input_ids, segment_ids, position_ids, input_mask, cfg,
                          is_test, pp_stages=pp_stages)
    if max_preds:
        ones = layers.fill_constant_batch_size_like(mask_pos, shape=[-1, 1],
                                                    dtype="int64", value=1)
        row_id = layers.cumsum(ones, axis=0, exclusive=True)  # [b, 1]
        flat_pos = layers.reshape(mask_pos + row_id * seq_len, [batch_size * max_preds])
        flat = layers.reshape(hidden, [batch_size * seq_len, cfg.hidden_size])
        picked = layers.gather(flat, flat_pos)  # [b * P, h]
        trans = _fc(picked, cfg.hidden_size, "mlm.trans", cfg,
                    act={"type": "gelu", "approximate": True}, num_flatten_dims=1)
        trans = layers.layer_norm(trans, begin_norm_axis=1, name="mlm.ln")
        logits = _mlm_logits(trans, cfg, num_flatten_dims=1)
        labels = layers.reshape(mlm_labels, [batch_size * max_preds, 1])
        per_tok = layers.softmax_with_cross_entropy(logits, labels)
        w = layers.reshape(mlm_weights, [batch_size * max_preds, 1])
    else:
        trans = _fc(hidden, cfg.hidden_size, "mlm.trans", cfg,
                    act={"type": "gelu", "approximate": True})
        trans = layers.layer_norm(trans, begin_norm_axis=2, name="mlm.ln")
        logits = _mlm_logits(trans, cfg, num_flatten_dims=2)
        labels = layers.reshape(mlm_labels, [batch_size, seq_len, 1])
        per_tok = layers.reshape(layers.softmax_with_cross_entropy(logits, labels),
                                 [batch_size, seq_len])
        w = mlm_weights
    masked = layers.elementwise_mul(per_tok, w)
    denom = layers.reduce_sum(w)
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(masked),
        layers.elementwise_add(denom, layers.fill_constant([1], "float32", 1e-6)),
    )
    handles = {
        "feeds": ["src_ids", "sent_ids", "pos_ids", "input_mask", "mask_label",
                  "mask_weight"] + (["mask_pos"] if max_preds else []),
        "hidden": hidden,
        "logits": logits,
        "mlm_loss": mlm_loss,
        "loss": mlm_loss,
    }
    if not mlm_only:
        nsp_labels = data("nsp_label", [batch_size, 1], dtype="int64",
                          append_batch_size=False)
        cls = layers.slice(hidden, [1], [0], [1])  # [b, 1, h]
        cls = layers.reshape(cls, [batch_size, cfg.hidden_size])
        pooled = layers.fc(
            cls, cfg.hidden_size, act="tanh",
            param_attr=ParamAttr(name="pooler.w_0", initializer=TruncatedNormal(0.0, 0.02)),
            bias_attr=ParamAttr(name="pooler.b_0", initializer=Constant(0.0)),
        )
        nsp_logits = layers.fc(
            pooled, 2,
            param_attr=ParamAttr(name="nsp.w_0", initializer=TruncatedNormal(0.0, 0.02)),
            bias_attr=ParamAttr(name="nsp.b_0", initializer=Constant(0.0)),
        )
        nsp_loss = layers.mean(layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))
        handles["feeds"].append("nsp_label")
        handles["nsp_loss"] = nsp_loss
        handles["loss"] = layers.elementwise_add(layers.reshape(mlm_loss, [1]),
                                                 layers.reshape(nsp_loss, [1]))
    return handles


def bert_flops_per_token(cfg, seq_len=None, max_preds=None) -> float:
    """Approximate training FLOPs per token, as the JAX package counts
    them: 3x the forward's 2 * params mult-adds, plus QK^T and PV per token
    when seq_len is given, and the vocab projection on max_preds / seq_len
    of the tokens with masked positions."""
    h, nl, ff, v = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size, cfg.vocab_size
    per_layer = 2 * (4 * h * h + 2 * h * ff)
    if seq_len:
        per_layer += 2 * 2 * seq_len * h
    embed_out = 2 * h * v
    if max_preds and seq_len:
        embed_out = embed_out * max_preds / seq_len
    return 3.0 * (nl * per_layer + embed_out)
