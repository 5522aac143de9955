"""The port's HF tokenizer reader (unidisc_tpu_torch/tokenizers/hf_text.py,
reached through tokenizers/text.py::get_tokenizer) against the JAX
package's get_tokenizer, which loads the same directory with
transformers' AutoTokenizer.

The tests build two tokenizers with the installed `tokenizers` library:
the LLaMA form (a BPE of a few hundred merges trained on a fixed corpus,
the 256 <0xNN> byte tokens in its vocabulary, byte_fallback and fuse_unk,
normalizer Prepend + Replace, decoder Replace / ByteFallback / Fuse /
Strip, tokenizer_class LlamaTokenizer with add_bos_token, and once with
add_eos_token too) and the GPT-2 form (ByteLevel pre-tokenizer, BPE and
decoder). Ids and decoded strings must equal transformers' exactly, over
ASCII, accents, CJK, emoji (byte fallback), runs of spaces, <image>
inside text, special tokens in text and the empty string, and over
random id rows; so must __call__ with padding and truncation, vocab_size,
len(), and the pad, eos and bos ids.
"""

import json
import os
import random

import numpy as np
import pytest
from tokenizers import (AddedToken, Tokenizer, decoders, models,
                        normalizers, pre_tokenizers, processors, trainers)

from unidisc_tpu.tokenizers.text import get_tokenizer as jax_tokenizer
from unidisc_tpu_torch.tokenizers.hf_text import HFTokenizer
from unidisc_tpu_torch.tokenizers.text import get_tokenizer

CORPUS = ["The quick brown fox jumps over the lazy dog.",
          "Hello world! Hello there, how are you doing today?",
          "A watercolor painting of a lighthouse at dusk, with waves.",
          "Généralement, les cafés sont ouverts le matin.",
          "東京は日本の首都です。", "numbers 12345 and 67890",
          "  spaces   here  ", "aaaa abab baba aaaaaa"] * 20
TEXTS = ["Hello world!", "", "  two  spaces ", "東京 é 😀",
         "a <image> b <image>", "<image>", "x<image>y", "don't stop . ?",
         "<s>hi</s>", "<|endoftext|>a", "tab\there\nnewline", "ÿ  z",
         "aaaa aaaaaa ababab", "🤖🤖 ok", "Généralement les cafés", "   ",
         "\n\n", "123 4567 89", "The quick brown fox jumps over the dog."]


def write_llama(path, **config):
    """A LLaMA-2-form tokenizer directory: the model vocabulary holds the
    three specials and the 256 byte tokens (ids 0..258, as LLaMA's)."""
    byte_tokens = [f"<0x{i:02X}>" for i in range(256)]
    norm = normalizers.Sequence([normalizers.Prepend("▁"),
                                 normalizers.Replace(" ", "▁")])
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    tok.normalizer = norm
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=3 + 256 + 500, special_tokens=["<unk>", "<s>", "</s>"]
        + byte_tokens, limit_alphabet=200, show_progress=False))
    vocab = tok.get_vocab()
    merges = [tuple(m) for m in json.loads(tok.to_str())["model"]["merges"]]
    # rebuilt so that only the three specials are added tokens
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               byte_fallback=True, fuse_unk=True))
    tok.normalizer = norm
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(),
        decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in ("<unk>", "<s>", "</s>")])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B",
        special_tokens=[("<s>", vocab["<s>"])])
    _save(path, tok, {"tokenizer_class": "LlamaTokenizer",
                      "add_bos_token": True, "add_eos_token": False,
                      "bos_token": "<s>", "eos_token": "</s>",
                      "unk_token": "<unk>", "pad_token": None,
                      "clean_up_tokenization_spaces": False,
                      "legacy": False, "model_max_length": 4096, **config})
    return len(merges)


def write_gpt2(path):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=256 + 1 + 400, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    _save(path, tok, {"tokenizer_class": "GPT2Tokenizer",
                      "bos_token": "<|endoftext|>",
                      "eos_token": "<|endoftext|>",
                      "unk_token": "<|endoftext|>",
                      "add_prefix_space": False, "model_max_length": 1024})


def _save(path, tok, config):
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


FORMS = ("llama", "llama_eos", "gpt2")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    merges = write_llama(str(root / "llama"))
    assert merges >= 200, merges             # a few hundred merges
    write_llama(str(root / "llama_eos"), add_eos_token=True)
    write_gpt2(str(root / "gpt2"))
    return {name: str(root / name) for name in FORMS}


def pair(dirs, form):
    return jax_tokenizer(dirs[form]), get_tokenizer(dirs[form])


@pytest.mark.parametrize("form", FORMS)
def test_attributes_equal_transformers(dirs, form):
    want, got = pair(dirs, form)
    for name in ("vocab_size", "pad_token", "pad_token_id", "eos_token_id",
                 "bos_token_id", "unk_token_id", "padding_side"):
        assert getattr(got, name) == getattr(want, name), name
    assert len(got) == len(want) == want.vocab_size + 1   # <image>
    assert got.get_vocab() == want.get_vocab()
    assert got.get_vocab()["<image>"] == len(want) - 1
    # the engine's calling convention reaches no HF tokenizer, in JAX either
    for tok in (want, got):
        with pytest.raises(TypeError):
            tok.encode("a cat", add_bos=True, add_eos=False)


@pytest.mark.parametrize("form", FORMS)
def test_ids_and_strings_equal_transformers(dirs, form):
    want, got = pair(dirs, form)
    rng = random.Random(0)
    alphabet = "".join(sorted(set("".join(CORPUS)))) + "😀🤖ÿ\t\n<>"
    texts = TEXTS + ["".join(rng.choice(alphabet) for _ in range(
        rng.randrange(1, 40))) for _ in range(60)]
    for text in texts:
        for add in (True, False):
            assert got.encode(text, add_special_tokens=add) == \
                want.encode(text, add_special_tokens=add), (text, add)
        ids = want.encode(text)
        for skip in (False, True):
            assert got.decode(ids, skip_special_tokens=skip) == \
                want.decode(ids, skip_special_tokens=skip), (text, skip)
    rows = [[rng.randrange(len(want)) for _ in range(rng.randrange(1, 12))]
            for _ in range(200)]
    assert got.batch_decode(rows) == want.batch_decode(rows)
    assert got.batch_decode(np.asarray(rows[:4], dtype=object)) == \
        want.batch_decode(rows[:4])


@pytest.mark.parametrize("form", FORMS)
def test_call_equals_transformers(dirs, form):
    want, got = pair(dirs, form)
    for kw in (dict(max_length=8, padding="max_length", truncation=True),
               dict(padding="longest"), dict(padding=True, max_length=5),
               dict(max_length=6), dict()):
        assert got(TEXTS[:6], **kw) == dict(want(TEXTS[:6], **kw)), kw
    assert got(TEXTS[0]) == dict(want(TEXTS[0]))


def test_unknown_steps_raise(dirs):
    with open(os.path.join(dirs["llama"], "tokenizer.json")) as f:
        spec = json.load(f)
    config = {"tokenizer_class": "LlamaTokenizer"}
    HFTokenizer(spec, config)
    for key, value, name in (
            ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece"),
            ("pre_tokenizer", {"type": "Metaspace"}, "Metaspace"),
            ("normalizer", {"type": "Strip"}, "Strip"),
            ("decoder", {"type": "WordPiece"}, "WordPiece")):
        with pytest.raises(NotImplementedError, match=name):
            HFTokenizer({**spec, key: value}, config)
    gpt2 = {"tokenizer_class": "GPT2Tokenizer"}
    with pytest.raises(NotImplementedError, match="TemplateProcessing"):
        HFTokenizer(spec, gpt2)         # a template only LLaMA's rewrites
    for cls in ("BertTokenizer", None):
        with pytest.raises(NotImplementedError, match="tokenizer_class"):
            HFTokenizer(spec, {"tokenizer_class": cls})
    with pytest.raises(NotImplementedError, match="ignore_merges"):
        HFTokenizer({**spec, "model": {**spec["model"],
                                       "ignore_merges": True}}, config)
    with pytest.raises(NotImplementedError, match="hub names"):
        get_tokenizer("meta-llama/Llama-2-7b-hf")
