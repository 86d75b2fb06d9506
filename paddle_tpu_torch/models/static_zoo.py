"""Static-graph model zoo (port of paddle_tpu/models/static_zoo.py).

The bundled model families built through the public `fluid.layers`
Program-recording API, as in the reference: each builder returns a
:class:`StaticModel` with the main and startup programs, the feed specs
(name, shape, dtype) a smoke batch needs, and the fetch targets a
training step asks for.  The builders are hermetic (their own
unique_name guard and programs), so a port builder and the reference's
build byte-identical `Program.to_json()`.

All eight families are ported: mlp, lenet, resnet, bert, gpt, seq2seq,
wide_deep and word2vec, with their default partition rules
(`DEFAULT_SHARDING_RULES`, the reference's): the transformers carry the
Megatron layout over a {dp, mp} mesh, the rest data parallelism over
{dp: 2}.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as L


class StaticModel:
    """One built static-graph model: programs + feed/fetch contract."""

    def __init__(self, name, main, startup, feeds, fetches,
                 loss_name=None):
        self.name = name
        self.main = main
        self.startup = startup
        self.feeds = list(feeds)          # [(name, shape, dtype)]
        self.fetches = list(fetches)      # fetch var names
        self.loss_name = loss_name

    @property
    def sharding_rules(self):
        """This family's default partition-rule document (the
        ``--sharding-rules`` file format): ``{"mesh", "rules",
        "data_axis"}``.  Every default set is PT3xx-clean on its own
        mesh."""
        return DEFAULT_SHARDING_RULES.get(
            self.name, DEFAULT_SHARDING_RULES["_default"])

    def partition_rules(self):
        """The default rules as a live analyzer object."""
        from ..analysis.sharding import PartitionRules

        return PartitionRules.from_dict(self.sharding_rules)

    def smoke_feed_shapes(self, batch=8):
        """Concrete feed shapes for one smoke batch."""
        return {name: tuple(batch if d is None else d for d in shape)
                for name, shape, _ in self.feeds}

    def op_types(self):
        """Every op type the model's programs emit (main + startup,
        all blocks)."""
        types = set()
        for prog in (self.main, self.startup):
            for b in prog.blocks:
                types.update(op.type for op in b.ops)
        return types

    def smoke_feed(self, batch=8, seed=0):
        """A well-shaped random feed dict for one smoke step (numpy, the
        reference's draws)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        feed = {}
        for name, shape, dtype in self.feeds:
            shape = tuple(batch if d is None else d for d in shape)
            if dtype.startswith("int"):
                feed[name] = rng.integers(0, 2, shape).astype(dtype)
            else:
                feed[name] = rng.standard_normal(shape).astype(dtype)
        return feed


def _train_tail(loss, optimizer):
    optimizer.minimize(loss)
    return loss


def build_mlp():
    """fit-a-line style regressor: fc stack + mse (models/mlp.py's
    static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [None, 13])
            y = fluid.data("y", [None, 1])
            h = L.fc(x, 32, act="relu")
            pred = L.fc(h, 1)
            loss = L.mean(L.square_error_cost(pred, y))
            _train_tail(loss, fluid.optimizer.SGD(0.01))
    return StaticModel("mlp", main, startup,
                       [("x", (None, 13), "float32"),
                        ("y", (None, 1), "float32")],
                       [loss.name], loss_name=loss.name)


def build_lenet():
    """recognize-digits convnet: conv/pool x2 + fc + softmax CE
    (models/lenet.py's static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            img = fluid.data("img", [None, 1, 28, 28])
            label = fluid.data("label", [None, 1], dtype="int64")
            c1 = L.conv2d(img, 6, 5, act="relu")
            p1 = L.pool2d(c1, 2, "max", 2)
            c2 = L.conv2d(p1, 16, 5, act="relu")
            p2 = L.pool2d(c2, 2, "max", 2)
            pred = L.fc(L.flatten(p2), 10, act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            acc = L.accuracy(pred, label)
            _train_tail(loss, fluid.optimizer.Adam(1e-3))
    return StaticModel("lenet", main, startup,
                       [("img", (None, 1, 28, 28), "float32"),
                        ("label", (None, 1), "int64")],
                       [loss.name, acc.name], loss_name=loss.name)


def _res_block(x, ch, stride=1):
    c1 = L.conv2d(x, ch, 3, stride=stride, padding=1, bias_attr=False)
    b1 = L.batch_norm(c1, act="relu")
    c2 = L.conv2d(b1, ch, 3, padding=1, bias_attr=False)
    b2 = L.batch_norm(c2)
    if stride != 1 or int(x.shape[1]) != ch:
        x = L.conv2d(x, ch, 1, stride=stride, bias_attr=False)
        x = L.batch_norm(x)
    return L.relu(L.elementwise_add(b2, x))


def build_resnet():
    """Small residual convnet (conv+BN blocks with skip adds, global
    avg pool) — models/resnet.py's static twin at toy scale."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            img = fluid.data("img", [None, 3, 16, 16])
            label = fluid.data("label", [None, 1], dtype="int64")
            x = L.batch_norm(
                L.conv2d(img, 8, 3, padding=1, bias_attr=False),
                act="relu")
            x = _res_block(x, 8)
            x = _res_block(x, 16, stride=2)
            x = L.pool2d(x, pool_type="avg", global_pooling=True)
            pred = L.fc(L.flatten(x), 10, act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            _train_tail(loss, fluid.optimizer.Momentum(0.01, 0.9))
    return StaticModel("resnet", main, startup,
                       [("img", (None, 3, 16, 16), "float32"),
                        ("label", (None, 1), "int64")],
                       [loss.name], loss_name=loss.name)


def _attention(x, d, heads, t):
    """Static multi-head self-attention over [B, T, D] via matmul +
    softmax (the transformer core both bert/gpt builders share)."""
    q = L.fc(x, d, num_flatten_dims=2)
    k = L.fc(x, d, num_flatten_dims=2)
    v = L.fc(x, d, num_flatten_dims=2)
    hd = d // heads

    def _split_heads(z):
        z = L.reshape(z, shape=[-1, t, heads, hd])
        return L.transpose(z, perm=[0, 2, 1, 3])

    q, k, v = _split_heads(q), _split_heads(k), _split_heads(v)
    scores = L.scale(L.matmul(q, k, transpose_y=True),
                     scale=hd ** -0.5)
    ctx = L.matmul(L.softmax(scores), v)
    ctx = L.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = L.reshape(ctx, shape=[-1, t, d])
    return L.fc(ctx, d, num_flatten_dims=2)


def _transformer_layer(x, d, heads, t):
    a = _attention(x, d, heads, t)
    x = L.layer_norm(L.elementwise_add(x, a), begin_norm_axis=2)
    f = L.fc(L.fc(x, d * 4, num_flatten_dims=2, act="gelu"), d,
             num_flatten_dims=2)
    return L.layer_norm(L.elementwise_add(x, f), begin_norm_axis=2)


def build_bert(t=16, d=32, heads=4, vocab=128):
    """Tiny BERT-style encoder: embedding + transformer layer + pooled
    2-class head (models/bert.py's static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            ids = fluid.data("ids", [None, t], dtype="int64")
            label = fluid.data("label", [None, 1], dtype="int64")
            tok = L.embedding(ids, size=(vocab, d))
            x = _transformer_layer(L.layer_norm(tok, begin_norm_axis=2),
                                   d, heads, t)
            # reduce_mean's layer leaves the declared shape unknown;
            # the reshape re-pins it so the fc head can size its W
            pooled = L.reshape(L.reduce_mean(x, dim=[1]),
                               shape=[-1, d])
            logits = L.fc(pooled, 2)
            loss = L.mean(L.softmax_with_cross_entropy(logits, label))
            _train_tail(loss, fluid.optimizer.Adam(1e-3))
    return StaticModel("bert", main, startup,
                       [("ids", (None, t), "int64"),
                        ("label", (None, 1), "int64")],
                       [loss.name], loss_name=loss.name)


def build_gpt(t=16, d=32, heads=4, vocab=128):
    """Tiny GPT-style LM: embedding + transformer layer + tied-width
    vocab head with per-token CE (models/gpt.py's static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            ids = fluid.data("ids", [None, t], dtype="int64")
            targets = fluid.data("targets", [None, t, 1], dtype="int64")
            x = L.embedding(ids, size=(vocab, d))
            x = _transformer_layer(x, d, heads, t)
            logits = L.fc(x, vocab, num_flatten_dims=2)
            loss = L.mean(L.softmax_with_cross_entropy(logits, targets))
            _train_tail(loss, fluid.optimizer.Adam(1e-3))
    return StaticModel("gpt", main, startup,
                       [("ids", (None, t), "int64"),
                        ("targets", (None, t, 1), "int64")],
                       [loss.name], loss_name=loss.name)


def build_seq2seq(t_src=12, t_tgt=8, d=24, vocab=96):
    """Simplified encoder-decoder: source embedding mean-pooled into a
    context vector, broadcast-concatenated with the target embedding,
    per-step vocab CE (models/seq2seq.py's static twin without the
    recurrent cell — op-vocabulary coverage, not fidelity)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            src = fluid.data("src", [None, t_src], dtype="int64")
            tgt = fluid.data("tgt", [None, t_tgt], dtype="int64")
            tgt_next = fluid.data("tgt_next", [None, t_tgt, 1],
                                  dtype="int64")
            enc = L.embedding(src, size=(vocab, d))
            ctx = L.reduce_mean(enc, dim=[1], keep_dim=True)
            ctx = L.expand(ctx, expand_times=[1, t_tgt, 1])
            # expand/reduce layers leave declared shapes unknown; the
            # reshape re-pins [B, T, D] so downstream fc can size W
            ctx = L.reshape(ctx, shape=[-1, t_tgt, d])
            dec = L.embedding(tgt, size=(vocab, d))
            h = L.concat([dec, ctx], axis=2)
            h = L.fc(h, d, num_flatten_dims=2, act="tanh")
            logits = L.fc(h, vocab, num_flatten_dims=2)
            loss = L.mean(L.softmax_with_cross_entropy(logits, tgt_next))
            _train_tail(loss, fluid.optimizer.Adam(1e-3))
    return StaticModel("seq2seq", main, startup,
                       [("src", (None, t_src), "int64"),
                        ("tgt", (None, t_tgt), "int64"),
                        ("tgt_next", (None, t_tgt, 1), "int64")],
                       [loss.name], loss_name=loss.name)


def build_wide_deep(fields=4, vocab=100, dense=8):
    """Wide&Deep CTR: sparse embeddings summed + dense tower, sigmoid
    CE (models/wide_deep.py's static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            ids = fluid.data("ids", [None, fields], dtype="int64")
            den = fluid.data("dense", [None, dense])
            label = fluid.data("label", [None, 1])
            emb = L.embedding(ids, size=(vocab, 8))
            deep_in = L.concat(
                [L.reshape(emb, shape=[-1, fields * 8]), den], axis=1)
            deep = L.fc(L.fc(deep_in, 32, act="relu"), 16, act="relu")
            wide = L.fc(den, 1)
            logit = L.elementwise_add(L.fc(deep, 1), wide)
            loss = L.mean(
                L.sigmoid_cross_entropy_with_logits(logit, label))
            _train_tail(loss, fluid.optimizer.Adagrad(0.05))
    return StaticModel("wide_deep", main, startup,
                       [("ids", (None, fields), "int64"),
                        ("dense", (None, dense), "float32"),
                        ("label", (None, 1), "float32")],
                       [loss.name], loss_name=loss.name)


def build_word2vec(window=4, vocab=120, d=16):
    """CBOW word2vec: context embeddings mean-pooled to predict the
    center word (models/word2vec.py's static twin)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            ctx = fluid.data("context", [None, window], dtype="int64")
            center = fluid.data("center", [None, 1], dtype="int64")
            emb = L.embedding(ctx, size=(vocab, d))
            pooled = L.reshape(L.reduce_mean(emb, dim=[1]),
                               shape=[-1, d])
            logits = L.fc(pooled, vocab)
            loss = L.mean(L.softmax_with_cross_entropy(logits, center))
            _train_tail(loss, fluid.optimizer.SGD(0.05))
    return StaticModel("word2vec", main, startup,
                       [("context", (None, window), "int64"),
                        ("center", (None, 1), "int64")],
                       [loss.name], loss_name=loss.name)


# ---------------------------------------------------------------------------
# default partition-rule sets: one document per family, in the rule-file
# format tools/program_lint.py --sharding-rules reads.  Ordered (regex,
# dims) pairs, first match wins; the final '.*' catch-all makes
# replication explicit (no PT301).  The transformer families carry the
# Megatron tensor-parallel layout over a 2-D {dp, mp} mesh: qkv/ffn-up
# column-sharded, attn-out/ffn-down row-sharded (the row shard's pending
# psum resolves at the bias add: one all-reduce per block), embedding
# vocab-sharded (masked-lookup psum).  Every set lints PT3xx-clean on its
# own mesh.
# ---------------------------------------------------------------------------

_TRANSFORMER_TP_RULES = [
    # attention q/k/v projections: column parallel
    [r"fc_0\.w_0$", [None, "mp"]],
    [r"fc_1\.w_0$", [None, "mp"]],
    [r"fc_2\.w_0$", [None, "mp"]],
    # attention output projection: row parallel (psum at the bias add)
    [r"fc_3\.w_0$", ["mp", None]],
    # ffn up: column parallel; ffn down: row parallel
    [r"fc_4\.w_0$", [None, "mp"]],
    [r"fc_5\.w_0$", ["mp", None]],
    # token embedding: vocab-sharded (masked-lookup psum)
    [r"embedding_0\.w_0$", ["mp", None]],
    # column-parallel biases shard with their weight's output dim (the
    # bias adds onto the still-sharded activation); row-parallel biases
    # (fc_3/fc_5) stay replicated: they add after the psum
    [r"fc_0\.b_0$", ["mp"]],
    [r"fc_1\.b_0$", ["mp"]],
    [r"fc_2\.b_0$", ["mp"]],
    [r"fc_4\.b_0$", ["mp"]],
    # everything else (row-parallel biases, norms, heads, optimizer
    # scalars): replicated, explicitly
    [r".*", []],
]

DEFAULT_SHARDING_RULES = {
    "_default": {
        "mesh": {"dp": 2},
        "data_axis": "dp",
        "rules": [[r".*", []]],
    },
    "bert": {
        "mesh": {"dp": 2, "mp": 2},
        "data_axis": "dp",
        "rules": list(_TRANSFORMER_TP_RULES),
    },
    "gpt": {
        "mesh": {"dp": 2, "mp": 2},
        "data_axis": "dp",
        "rules": list(_TRANSFORMER_TP_RULES),
    },
}


BUILDERS = {
    "mlp": build_mlp,
    "lenet": build_lenet,
    "resnet": build_resnet,
    "bert": build_bert,
    "gpt": build_gpt,
    "seq2seq": build_seq2seq,
    "wide_deep": build_wide_deep,
    "word2vec": build_word2vec,
}


def build(name):
    """Build one bundled static model by family name."""
    try:
        fn = BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"unknown static model '{name}'; available: "
            f"{sorted(BUILDERS)}") from None
    # called outside the except: a KeyError raised inside a builder
    # surfaces as itself
    return fn()


def build_all():
    return {name: fn() for name, fn in BUILDERS.items()}
