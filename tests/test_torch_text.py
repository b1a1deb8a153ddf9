"""``text`` held to paddle_tpu's: the native WordPiece tokenizer (the twins
of ``tests/test_fast_tokenizer.py``), the seven text datasets over
archives written here in their original formats (the twins of
``tests/test_text_datasets.py`` and the text case of
``tests/test_highlevel.py``), and the text pipelines of
``tests/test_text_e2e.py``.

The tokenizers and datasets of both packages read the same inputs; ids,
items and vocabularies are compared exactly.  The port's tokenizer
builds from its own copy of the C++ source into ``build/``; the
end-to-end cases train the port on batches held equal to paddle_tpu's
loader's, and the regression case trains both from the same weights
(losses within 1e-5 relative)."""
import gzip
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.text.datasets as jtd
from paddle_tpu import io as jio, nn as jnn, optimizer as jopt
from paddle_tpu.text import FastWordPieceTokenizer as JTok

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.text.datasets as ttd
from paddle_tpu_torch import io as tio, nn as tnn, optimizer as topt
from paddle_tpu_torch.core import placement
from paddle_tpu_torch.text import FastWordPieceTokenizer as TTok
from paddle_tpu_torch.text import fast_tokenizer as tft

DS = {"jax": jtd, "torch": ttd}
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown",
         "fox", "jump", "##ed", "##s", "over", "lazy", "dog", ",", ".",
         "un", "##believ", "##able"]
TEXTS = ["The quick brown fox jumped over the lazy dog.",
         "unbelievable, jumps!", "", "THE UNBELIEVABLE FOX",
         "xyzzy plugh", "a\xa0b", "café FOX", "Énorme"]


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.set_device("cpu")
    yield
    placement.set_default(None)


# -- the tokenizer -----------------------------------------------------------
def test_native_builds_from_the_ports_source_and_matches_the_oracles():
    native = TTok(VOCAB)
    assert native.is_native
    assert tft._library_path(os.path.join(tft._CSRC, "fast_tokenizer.cpp")
                             ).startswith(tft.BUILD_DIR)
    for max_len in (16, 8, 3):
        a, la = native.encode_batch(TEXTS, max_len=max_len)
        b, lb = TTok(VOCAB, use_native=False).encode_batch(TEXTS, max_len)
        c, lc = JTok(VOCAB).encode_batch(TEXTS, max_len=max_len)
        assert a.dtype == c.dtype == np.int32
        for x, y in ((b, lb), (c, lc)):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(la, y)


def test_wordpiece_continuation_and_framing():
    t = TTok(VOCAB, use_native=False)
    ids, lens = t.encode_batch(["unbelievable"], max_len=8)
    v = t.vocab
    assert ids[0, 0] == v["[CLS]"]
    assert list(ids[0, 1:4]) == [v["un"], v["##believ"], v["##able"]]
    assert ids[0, 4] == v["[SEP]"] and ids[0, 5] == v["[PAD]"]
    assert lens[0] == 5


def test_unknown_word_truncation_and_short_max_len():
    t = TTok(VOCAB)
    ids, _ = t.encode_batch(["xyzzy"], max_len=8)
    assert ids[0, 1] == t.unk_id
    ids, lens = t.encode_batch([" ".join(["fox"] * 100)], max_len=16)
    assert lens[0] == 16 and ids[0, -1] == t.vocab["[SEP]"]
    with pytest.raises(ValueError, match="max_len"):
        t.encode_batch(["fox"], max_len=1)
    np.testing.assert_array_equal(t("the fox", 6), JTok(VOCAB)("the fox", 6))


def test_multithreaded_batch_consistent():
    t = TTok(VOCAB)
    texts = ["the quick brown fox"] * 257 + ["unbelievable dog ."] * 255
    a, _ = t.encode_batch(texts, max_len=12, n_threads=8)
    b, _ = t.encode_batch(texts, max_len=12, n_threads=1)
    np.testing.assert_array_equal(a, b)


def test_empty_batch_vocab_file_and_dict(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    for t in (TTok(str(p)), TTok({w: i for i, w in enumerate(VOCAB)})):
        ids, lens = t.encode_batch([], max_len=8)
        assert ids.shape == (0, 8) and lens.shape == (0,)
        assert len(t) == len(VOCAB)
        np.testing.assert_array_equal(t.encode_batch(TEXTS, 10)[0],
                                      JTok(VOCAB).encode_batch(TEXTS, 10)[0])


# -- the datasets' archives --------------------------------------------------
def _add_bytes(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _make_imdb(path, docs):
    with tarfile.open(path, "w:gz") as tf:
        for (mode, sub, i), text in docs.items():
            _add_bytes(tf, f"aclImdb/{mode}/{sub}/{i}.txt", text.encode())


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
            assert np.asarray(u).dtype == np.asarray(v).dtype


def test_imdb_parses_tar_and_builds_vocab(tmp_path):
    p = str(tmp_path / "aclImdb_v1.tar.gz")
    docs = {}
    for i in range(3):
        docs[("train", "pos", i)] = "good, good."
        docs[("train", "neg", i)] = "bad! bad?"
    docs[("train", "pos", 3)] = "meh meh good bad"
    docs[("test", "pos", 0)] = "good meh"
    docs[("test", "neg", 0)] = "bad unknownword"
    _make_imdb(p, docs)
    for mode in ("train", "test"):
        got = {s: d.Imdb(data_file=p, mode=mode, cutoff=3)
               for s, d in DS.items()}
        assert got["torch"].word_idx == got["jax"].word_idx
        _same(_items(got["torch"]), _items(got["jax"]))
    ds = ttd.Imdb(data_file=p, mode="train", cutoff=3)
    assert ds.word_idx[b"bad"] == 0 and ds.word_idx[b"good"] == 1
    assert ds.word_idx[b"<unk>"] == 2 and len(ds) == 7
    doc0, label0 = ds[0]
    assert doc0.tolist() == [1, 1] and label0.tolist() == [0]


@pytest.mark.parametrize("cls", ["Imdb", "Imikolov", "Movielens",
                                 "UCIHousing", "WMT14", "WMT16"])
def test_datasets_require_a_local_file(cls):
    with pytest.raises(ValueError, match="local archive"):
        getattr(ttd, cls)(data_file=None)
    with pytest.raises(FileNotFoundError):
        getattr(ttd, cls)(data_file="/nonexistent/archive")


def test_imikolov_ngram_and_seq(tmp_path):
    p = str(tmp_path / "simple-examples.tar")
    with tarfile.open(p, "w") as tf:
        for split, lines in (("train", ["a b a", "a b", "b"]),
                             ("valid", ["a a"]), ("test", ["a a"])):
            _add_bytes(tf, f"./simple-examples/data/ptb.{split}.txt",
                       "\n".join(lines).encode() + b"\n")
    for kw in (dict(data_type="NGRAM", window_size=2, mode="train"),
               dict(data_type="SEQ", window_size=-1, mode="test")):
        got = {s: d.Imikolov(data_file=p, min_word_freq=2, **kw)
               for s, d in DS.items()}
        assert got["torch"].word_idx == got["jax"].word_idx
        _same(_items(got["torch"]), _items(got["jax"]))
    ds = ttd.Imikolov(data_file=p, data_type="NGRAM", window_size=2,
                      mode="train", min_word_freq=2)
    assert [tuple(int(x) for x in ds[i]) for i in range(4)] == [
        (2, 0), (0, 3), (3, 0), (0, 1)]


def test_movielens_parses_zip(tmp_path):
    p = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("ml-1m/movies.dat", b"1::Toy Story (1995)::Animation|"
                   b"Comedy\n2::Heat (1995)::Action\n")
        z.writestr("ml-1m/users.dat", b"1::M::25::3::90210\n"
                   b"2::F::30::7::10001\n")
        z.writestr("ml-1m/ratings.dat", b"1::1::5::978300760\n"
                   b"2::2::3::978302109\n")
    got = {}
    for s, d in DS.items():
        ds = d.Movielens(data_file=p, mode="train", test_ratio=0.0)
        got[s] = sorted(_items(ds), key=lambda it: int(it[0][0]))
    _same(got["torch"], got["jax"])
    usr1 = got["torch"][0]
    assert [usr1[k].tolist() for k in (1, 2, 3, 4, 7)] == [
        [0], [25], [3], [1], [5.0]]
    assert got["torch"][1][7].tolist() == [1.0]


def test_conll05_srl_tuples(tmp_path):
    buf_w, buf_p = io.BytesIO(), io.BytesIO()
    with gzip.GzipFile(fileobj=buf_w, mode="w") as g:
        g.write(b"The\ncat\nsat\n\n")
    with gzip.GzipFile(fileobj=buf_p, mode="w") as g:
        g.write(b"-\t(A0*\n-\t*)\nsat\t(V*)\n\n")
    tar_p = str(tmp_path / "conll05st.tar")
    with tarfile.open(tar_p, "w") as tf:
        _add_bytes(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                   buf_w.getvalue())
        _add_bytes(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                   buf_p.getvalue())
    paths = {}
    for name, text in (("word", "The\ncat\nsat\n"), ("verb", "sat\n"),
                       ("target", "B-A0\nI-A0\nB-V\nI-V\nO\n")):
        paths[name] = str(tmp_path / f"{name}.dict")
        open(paths[name], "w").write(text)
    got = {s: d.Conll05st(data_file=tar_p, word_dict_file=paths["word"],
                          verb_dict_file=paths["verb"],
                          target_dict_file=paths["target"])
           for s, d in DS.items()}
    assert got["torch"].get_dict() == got["jax"].get_dict()
    _same(_items(got["torch"]), _items(got["jax"]))
    (word_idx, _, c_n1, c_0, _, _, pred_idx, mark,
     label_idx) = got["torch"][0]
    ld = got["torch"].label_dict
    assert word_idx.tolist() == [0, 1, 2] and pred_idx.tolist() == [0] * 3
    assert label_idx.tolist() == [ld["B-A0"], ld["I-A0"], ld["B-V"]]
    assert mark.tolist() == [1, 1, 1] and c_0.tolist() == [2, 2, 2]


def test_uci_housing_normalisation(tmp_path):
    data = np.random.RandomState(0).rand(10, 14) * 10
    p = str(tmp_path / "housing.data")
    with open(p, "w") as f:
        for r in data:
            f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
    for mode, n in (("train", 8), ("test", 2)):
        got = {s: _items(d.UCIHousing(data_file=p, mode=mode))
               for s, d in DS.items()}
        _same(got["torch"], got["jax"])
        assert len(got["torch"]) == n
    feat, target = ttd.UCIHousing(data_file=p, mode="train")[0]
    mx, mn, avg = data[:, 0].max(), data[:, 0].min(), data[:, 0].mean()
    assert feat[0] == pytest.approx((data[0, 0] - avg) / (mx - mn), rel=1e-5)
    assert target[0] == pytest.approx(data[0, 13], rel=1e-5)


def test_wmt14_bitext(tmp_path):
    p = str(tmp_path / "wmt14.tgz")
    with tarfile.open(p, "w:gz") as tf:
        _add_bytes(tf, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _add_bytes(tf, "wmt14/trg.dict",
                   b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _add_bytes(tf, "wmt14/train/train", b"hello world\tbonjour monde\n"
                   b"hello novel\tbonjour nouveau\n")
        _add_bytes(tf, "wmt14/test/test", b"world\tmonde\n")
    for mode in ("train", "test"):
        got = {s: d.WMT14(data_file=p, mode=mode, dict_size=5)
               for s, d in DS.items()}
        _same(_items(got["torch"]), _items(got["jax"]))
        assert got["torch"].get_dict(reverse=True) == \
            got["jax"].get_dict(reverse=True)
    ds = ttd.WMT14(data_file=p, mode="train", dict_size=5)
    assert [x.tolist() for x in ds[0]] == [[0, 3, 4, 1], [0, 3, 4],
                                           [3, 4, 1]]
    assert ds[1][0].tolist() == [0, 3, 2, 1]


def _make_wmt16(path, train=b"hello world\thallo welt\nhello there\thallo"
                b" da\nworld cup\twelt pokal\n"):
    with tarfile.open(path, "w") as tf:
        _add_bytes(tf, "wmt16/train", train)
        _add_bytes(tf, "wmt16/test", b"hello\thallo\n")
        _add_bytes(tf, "wmt16/val", b"world\twelt\n")


def test_wmt16_builds_and_caches_dicts(tmp_path):
    p = str(tmp_path / "wmt16.tar")
    _make_wmt16(p)
    got = {}
    for s, d in DS.items():
        cache = tmp_path / f"cache_{s}"
        cache.mkdir()
        ds = d.WMT16(data_file=p, mode="test", src_dict_size=5,
                     trg_dict_size=5, lang="en", dict_cache_dir=str(cache))
        de = d.WMT16(data_file=p, mode="val", src_dict_size=5,
                     trg_dict_size=5, lang="de", dict_cache_dir=str(cache))
        got[s] = (ds, de, sorted(os.listdir(cache)))
    for k in (0, 1):
        _same(_items(got["torch"][k]), _items(got["jax"][k]))
        assert got["torch"][k].src_dict == got["jax"][k].src_dict
    assert got["torch"][2] == got["jax"][2] and len(got["torch"][2]) == 2
    ds = got["torch"][0]
    assert ds.src_dict["hello"] == 3 and ds.trg_dict["hallo"] == 3
    assert [x.tolist() for x in ds[0]] == [[0, 3, 1], [0, 3], [3, 1]]
    p2 = str(tmp_path / "wmt16b.tar")
    _make_wmt16(p2, b"apple tree\tapfel baum\n")
    ds2 = ttd.WMT16(data_file=p2, mode="test", src_dict_size=5,
                    trg_dict_size=5, dict_cache_dir=str(tmp_path /
                                                        "cache_torch"))
    assert ds2.src_dict.get("apple") == 3
    assert ds.get_dict("en", reverse=True)[3] == "hello"


# -- text pipelines (test_text_e2e.py, test_highlevel.py) --------------------
DOC_LEN = 32


@pytest.fixture(scope="module")
def imdb_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("imdb") / "aclImdb_v1.tar.gz")
    rs = np.random.RandomState(0)
    vocab = [f"word{i:02d}" for i in range(24)]
    with tarfile.open(path, "w:gz") as tf:
        for mode, n in (("train", 64), ("test", 16)):
            for i in range(n):
                sub = "pos" if i % 2 == 0 else "neg"
                lo, hi = (0, 16) if sub == "pos" else (8, 24)
                words = [vocab[j] for j in rs.randint(lo, hi, DOC_LEN)]
                _add_bytes(tf, f"aclImdb/{mode}/{sub}/{i}.txt",
                           " ".join(words).encode())
    return path


class LstmClassifier(tnn.Layer):
    def __init__(self, vocab, emb=16, hidden=16, classes=2):
        super().__init__()
        self.embedding = tnn.Embedding(vocab, emb)
        self.lstm = tnn.LSTM(emb, hidden)
        self.head = tnn.Linear(hidden, classes)

    def forward(self, ids):
        out, _ = self.lstm(self.embedding(ids))
        return self.head(out.mean(axis=1))


def test_imdb_loader_batches_match_and_lstm_trains(imdb_file):
    batches = {}
    for s, (d, io_) in {"jax": (jtd, jio), "torch": (ttd, tio)}.items():
        ds = d.Imdb(data_file=imdb_file, mode="train", cutoff=5)
        batches[s] = [(np.asarray(x.numpy()), np.asarray(y.numpy()))
                      for x, y in io_.DataLoader(ds, batch_size=16)]
    for (a, b), (c, e) in zip(batches["torch"], batches["jax"]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)
    ds = ttd.Imdb(data_file=imdb_file, mode="train", cutoff=5)
    tpaddle.seed(60)
    model = LstmClassifier(len(ds.word_idx))
    opt = topt.Adam(learning_rate=5e-3, parameters=model.parameters())
    losses = []
    loader = tio.DataLoader(ds, batch_size=16, shuffle=True)
    for _ in range(3):
        for ids, labels in loader:
            loss = TF.cross_entropy(model(ids), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    assert np.isfinite(losses).all() and min(losses[-4:]) < losses[0]


def test_imdb_tokenizer_pipeline(imdb_file):
    ds = ttd.Imdb(data_file=imdb_file, mode="test", cutoff=5)
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for w in list(ds.word_idx)[:50]:
        vocab.setdefault(w.decode() if isinstance(w, bytes) else w,
                         len(vocab))
    ids, lens = TTok(vocab=vocab).encode_batch(["w1 w2 w3", "w5 w4"], 16)
    ref, ref_lens = JTok(vocab=vocab).encode_batch(["w1 w2 w3", "w5 w4"], 16)
    np.testing.assert_array_equal(ids, ref)
    assert ids.shape == (2, 16) and lens.tolist() == ref_lens.tolist() \
        == [5, 4]
    out = LstmClassifier(len(vocab))(tpaddle.to_tensor(ids))
    assert tuple(out.shape) == (2, 2)


def test_wmt16_seq2seq_beam_decode_smoke(tmp_path):
    rs = np.random.RandomState(1)
    en = [f"en{i:02d}" for i in range(40)]
    de = [f"de{i:02d}" for i in range(40)]

    def lines(n):
        return ("\n".join(
            " ".join(en[j] for j in rs.randint(0, 40, 22)) + "\t"
            + " ".join(de[j] for j in rs.randint(0, 40, 22))
            for _ in range(n)) + "\n").encode()
    p = str(tmp_path / "wmt16.tar")
    with tarfile.open(p, "w") as tf:
        _add_bytes(tf, "wmt16/train", lines(30))
        _add_bytes(tf, "wmt16/test", lines(6))
        _add_bytes(tf, "wmt16/val", lines(3))
    got = {s: d.WMT16(data_file=p, mode="test", src_dict_size=200,
                      trg_dict_size=200, dict_cache_dir=str(tmp_path))
           for s, d in DS.items()}
    _same(_items(got["torch"]), _items(got["jax"]))
    ds = got["torch"]
    src, tgt_in, _ = ds[0]
    assert src.shape == (24,) and tgt_in.shape == (23,)
    tpaddle.seed(61)
    emb, enc = tnn.Embedding(200, 16), tnn.LSTM(16, 16)
    cell, temb, out = tnn.LSTMCell(16, 16), tnn.Embedding(200, 16), \
        tnn.Linear(16, 200)
    _, (h, c) = enc(emb(tpaddle.to_tensor(np.stack([ds[i][0]
                                                    for i in range(4)]))))

    class _Cell(tnn.Layer):
        def forward(self, ids, states):
            y, new = cell(temb(ids), states)
            return out(y), new

    dec = tnn.BeamSearchDecoder(_Cell(), start_token=1, end_token=0,
                                beam_size=3)
    seq, scores = tnn.dynamic_decode(dec, (h[0], c[0]), max_step_num=6)
    assert np.asarray(seq.numpy()).shape[0] == 4
    assert np.isfinite(np.asarray(scores.numpy())).all()


def test_uci_housing_regression_trains_as_paddle_tpu(tmp_path):
    rs = np.random.RandomState(2)
    X = rs.rand(80, 13) * 10
    y = X @ rs.rand(13) + 0.1 * rs.rand(80)
    p = str(tmp_path / "housing.data")
    with open(p, "w") as f:
        for xi, yi in zip(X, y):
            f.write(" ".join(f"{v:.6f}" for v in xi) + f" {yi:.6f}\n")
    w0 = {"weight": rs.randn(13, 1).astype(np.float32) * 0.1,
          "bias": np.zeros(1, np.float32)}
    losses = {}
    for s, (paddle, d, nn, opt) in {
            "jax": (jpaddle, jtd, jnn, jopt),
            "torch": (tpaddle, ttd, tnn, topt)}.items():
        ds = d.UCIHousing(data_file=p, mode="train")
        x = paddle.to_tensor(np.stack([ds[i][0] for i in range(64)]))
        t = paddle.to_tensor(np.stack([ds[i][1] for i in range(64)]))
        net = nn.Linear(13, 1)
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in w0.items()})
        sgd = opt.SGD(learning_rate=0.05, parameters=net.parameters())
        out = []
        for _ in range(20):
            loss = ((net(x) - t) ** 2).mean()
            loss.backward()
            sgd.step()
            sgd.clear_grad()
            out.append(float(loss))
        losses[s] = out
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0] * 0.5
