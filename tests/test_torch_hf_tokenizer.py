"""The port's tokenizer.json interpreter (dynamo_tpu_torch.llm.hf_tokenizer)
against the reference's HfTokenizer, which wraps the `tokenizers` package.

Each tokenizer.json is built in a temporary directory with `tokenizers`:
a Llama-3-form byte-level BPE (Split regex + ByteLevel, ignore_merges)
trained by BpeTrainer on a multilingual corpus, with special and added
tokens; a SentencePiece-form BPE with byte_fallback and Metaspace; the
older SentencePiece form (Prepend + Replace normalizers, a
Replace/ByteFallback/Fuse/Strip decoder); a GPT-2-form byte-level BPE with
Lowercase and individual Digits; a WordLevel vocabulary; and a Split
pre-tokenizer under every behavior, inverted and not. Over hypothesis text
(non-BMP, combining marks, digit and whitespace runs, special-token
strings) `encode`, `decode`, `token_text`, `vocab_size`, `eos_token_ids`
and `chat_template` must equal the reference's, and so must streaming
detokenization and guided decoding's token bytes.

The text draws from scripts assigned long ago: the port normalizes with
Python's unicodedata (Unicode 15.0), the `tokenizers` package with its own
older tables, and the two disagree on code points assigned in between.
"""

import json
import os
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    trainers,
)

from dynamo_tpu.llm import guided as j_guided
from dynamo_tpu.llm.tokenizer import HfTokenizer as RefTokenizer
from dynamo_tpu.llm.tokenizer import IncrementalDetokenizer as RefDetok
from dynamo_tpu_torch.llm import guided
from dynamo_tpu_torch.llm.hf_tokenizer import (
    HfTokenizer,
    UnsupportedTokenizer,
    _is_word_char,
    translate_regex,
)
from dynamo_tpu_torch.llm.tokenizer import IncrementalDetokenizer, load_tokenizer

CORPUS = [
    "Hello world! The quick brown fox jumps over the lazy dog 12345 times.",
    "Bonjour à tous, ça va? Ünïcödé ñandú façade naïve café.",
    "日本語のテキストです。中文文本也在这里。한국어 문장도 있습니다.",
    "Привет мир! Γειά σου κόσμε. مرحبا بالعالم. שלום עולם.",
    "emoji 😀🎉👍🏽 and math 𝐀𝐁𝐂 ∑∫√ symbols ©®™",
    "   multiple   spaces\t\ttabs\n\nnewlines\r\n 3.14159 2024-01-01 1,000",
    "def f(x):\n    return x ** 2  # code\n",
    "'s 't 're 've 'm 'll 'd I'M YOU'RE it's",
]
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>", "<|start_header_id|>",
            "<|end_header_id|>"]
TEMPLATE = ("{% for m in messages %}<|start_header_id|>{{ m['role'] }}"
            "<|end_header_id|>\n\n{{ m['content'] }}<|eot_id|>{% endfor %}")
BYTE_FALLBACK = [f"<0x{b:02X}>" for b in range(256)]


def _train(tok, vocab_size, special_tokens=(), alphabet=()):
    tok.train_from_iterator(CORPUS * 10, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(special_tokens),
        initial_alphabet=list(alphabet), show_progress=False))


def _llama3():
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    _train(tok, 700, SPECIALS[:2], pre_tokenizers.ByteLevel.alphabet())
    tok.add_special_tokens([AddedToken(t, special=True)
                            for t in SPECIALS[2:]])
    tok.add_tokens([AddedToken("<tool>", normalized=False),
                    AddedToken(" xyz", lstrip=True, rstrip=True),
                    AddedToken("hello", single_word=True)])
    return tok


def _sentencepiece():
    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>",
                               fuse_unk=True))
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Sequence([
        decoders.Metaspace(prepend_scheme="first"), decoders.ByteFallback(),
        decoders.Fuse()])
    _train(tok, 520, ["<unk>", "<s>", "</s>"] + BYTE_FALLBACK)
    return tok


def _sentencepiece_legacy():
    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(),
        decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    _train(tok, 420, ["<unk>", "<s>", "</s>"] + BYTE_FALLBACK[:128])
    tok.add_special_tokens(["[INST]", "[/INST]"])
    return tok


def _gpt2():
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.Sequence([normalizers.NFC(),
                                           normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Digits(individual_digits=True),
        pre_tokenizers.ByteLevel(add_prefix_space=True)])
    tok.decoder = decoders.ByteLevel()
    _train(tok, 600, ["<|endoftext|>"], pre_tokenizers.ByteLevel.alphabet())
    tok.add_tokens([AddedToken("mañana", normalized=True)])
    return tok


def _wordlevel():
    words = sorted({w for line in CORPUS for w in line.split()})
    vocab = {w: i for i, w in enumerate(["[UNK]", "-"] + words)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.Split("-", behavior="merged_with_previous")])
    tok.add_special_tokens(["<eos>"])
    return tok


def _split(behavior, invert):
    def build():
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Split(
            Regex(r"\p{N}+|[,.]\s*"), behavior=behavior, invert=invert)
        tok.decoder = decoders.Fuse()
        _train(tok, 300, ["<unk>"])
        return tok
    return build


KINDS = {"llama3": _llama3, "sentencepiece": _sentencepiece,
         "sentencepiece_legacy": _sentencepiece_legacy, "gpt2": _gpt2,
         "wordlevel": _wordlevel}
for _b in ("removed", "isolated", "merged_with_previous", "merged_with_next",
           "contiguous"):
    for _inv in (False, True):
        KINDS[f"split_{_b}{'_inverted' if _inv else ''}"] = _split(_b, _inv)


@pytest.fixture(scope="module")
def tokenizers_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    for name, build in KINDS.items():
        d = root / name
        d.mkdir()
        build().save(str(d / "tokenizer.json"))
    # the Llama-3 form carries its config files, as a checkpoint does
    llama = root / "llama3"
    (llama / "tokenizer_config.json").write_text(json.dumps(
        {"chat_template": TEMPLATE, "eos_token": {"content": "<|eot_id|>"}}))
    (llama / "generation_config.json").write_text(json.dumps(
        {"eos_token_id": [1, 0]}))
    return root


@pytest.fixture(scope="module")
def pairs(tokenizers_dir):
    return {name: (RefTokenizer(str(tokenizers_dir / name)),
                   HfTokenizer(str(tokenizers_dir / name)))
            for name in KINDS}


# long-assigned scripts: ASCII, Latin, combining marks, Greek, Cyrillic,
# Hebrew, Arabic and its digits, Devanagari digits, CJK, kana, Hangul,
# fullwidth forms, emoji, mathematical alphanumerics (non-BMP)
_RANGES = [(0x20, 0x7E), (0xA0, 0x17F), (0x300, 0x36F), (0x391, 0x3C9),
           (0x410, 0x44F), (0x5D0, 0x5EA), (0x620, 0x64A), (0x660, 0x669),
           (0x966, 0x96F), (0x3040, 0x30FF), (0x4E00, 0x4E80),
           (0xAC00, 0xAC40), (0xFF01, 0xFF5E), (0x1F600, 0x1F64F),
           (0x1D400, 0x1D4FF)]
_CHARS = st.one_of(
    *(st.integers(lo, hi).map(chr) for lo, hi in _RANGES),
    st.sampled_from(list("\t\n\r\x0b\x0c\x1c\x1f　  0123456789'")),
)
_PIECES = st.one_of(
    st.text(_CHARS, max_size=12),
    st.sampled_from(SPECIALS + ["<tool>", " xyz ", "hello", "[INST]",
                                "<eos>", "mañana", "MAÑANA", "   ", "\n\n",
                                "12345678", "-", "'s", "I'M", "world"]),
)
TEXT = st.lists(_PIECES, max_size=8).map("".join)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT, extra=st.lists(st.integers(0, 800), max_size=12))
@pytest.mark.parametrize("name", sorted(KINDS))
def test_encode_decode_match_reference(pairs, name, text, extra):
    ref, port = pairs[name]
    ids = ref.encode(text)
    assert port.encode(text) == ids
    assert port.decode(ids) == ref.decode(ids)
    # arbitrary ids, special ones and ids outside the vocabulary included
    assert port.decode(extra) == ref.decode(extra)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_vocabulary_matches_reference(pairs, name):
    ref, port = pairs[name]
    assert port.vocab_size == ref.vocab_size
    for i in range(ref.vocab_size + 3):
        assert port.token_text(i) == ref.token_text(i), i
    assert port.eos_token_ids == ref.eos_token_ids
    assert port.chat_template == ref.chat_template
    assert port.stable_window == ref.stable_window


def test_config_files_are_read_as_the_reference(pairs):
    ref, port = pairs["llama3"]
    eot = port.token_to_id("<|eot_id|>")
    assert port.chat_template == TEMPLATE
    assert port.eos_token_ids == [eot, 0] == ref.eos_token_ids


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
@pytest.mark.parametrize("name", ["llama3", "sentencepiece",
                                  "sentencepiece_legacy", "gpt2"])
def test_streaming_detokenizer_matches_reference(pairs, name, text):
    ref, port = pairs[name]
    ids = ref.encode(text)
    a, b = RefDetok(ref), IncrementalDetokenizer(port)
    for tid in ids:
        assert b.push([tid]) == a.push([tid])
    assert b.flush() == a.flush()


@pytest.mark.parametrize("name", ["llama3", "sentencepiece", "gpt2",
                                  "wordlevel"])
def test_guided_token_bytes_match_reference(pairs, name):
    ref, port = pairs[name]
    assert guided.token_bytes_for(port) == j_guided.token_bytes_for(ref)


def test_added_token_options():
    """single_word, lstrip and rstrip at the edges that decide them."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _llama3().save(os.path.join(d, "tokenizer.json"))
        ref, port = RefTokenizer(d), HfTokenizer(d)
        hello, xyz = port.token_to_id("hello"), port.token_to_id(" xyz")
        for text in ("hello", "say hello!", "hellos", "_hello", "éhello",
                     "a  xyz  b", "xyz", "a xyz", "<|eot_id|> xyz <tool>"):
            assert port.encode(text) == ref.encode(text), text
        assert hello in port.encode("say hello!")
        assert hello not in port.encode("hellos")
        assert port.encode("a  xyz  b").count(xyz) == 1


# word characters by the tokenizers library's Unicode \w: marks (Mn, Mc, Me),
# an Other_Alphabetic symbol (So), Pc and Join_Control; No is not one
@pytest.mark.parametrize("char,word", [
    ("\u0300", True), ("\u0903", True), ("\u20dd", True), ("\u24b6", True),
    ("\u203f", True), ("\u200c", True), ("\u200d", True),
    ("\u00b2", False), ("\u00bd", False)])
def test_single_word_boundary_is_unicode_word(pairs, char, word):
    ref, port = pairs["llama3"]
    hello = port.token_to_id("hello")
    for text in (char + "hello", "hello" + char):
        assert port.encode(text) == ref.encode(text), text
        assert (hello in port.encode(text)) is not word, text
    assert _is_word_char(char) is word


def test_word_chars_match_tokenizers_over_every_code_point():
    """One encode of c + "hello " for every assigned code point: the
    single_word token matches exactly where c is not a word character."""
    tok = Tokenizer(models.WordLevel({"[UNK]": 0}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.add_tokens([AddedToken("hello", single_word=True, normalized=False)])
    hello = tok.token_to_id("hello")
    chars = [chr(cp) for cp in range(0x110000)
             if unicodedata.category(chr(cp)) not in ("Cs", "Cn")]
    enc = tok.encode("".join(c + "hello " for c in chars),
                     add_special_tokens=False)
    matched = {start for tid, (start, _) in zip(enc.ids, enc.offsets)
               if tid == hello}
    differ = [hex(ord(c)) for i, c in enumerate(chars)
              if (7 * i + 1 not in matched) != _is_word_char(c)]
    assert not differ, differ[:20]


def test_load_tokenizer_builds_the_hf_kind(tokenizers_dir):
    tok = load_tokenizer({"kind": "hf", "path": str(tokenizers_dir /
                                                    "llama3")})
    assert isinstance(tok, HfTokenizer)
    assert tok.file == str(tokenizers_dir / "llama3" / "tokenizer.json")


@pytest.mark.parametrize("section,component", [
    ("model", {"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "a"}),
    ("normalizer", {"type": "BertNormalizer"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("decoder", {"type": "WordPiece", "prefix": "##"}),
    ("post_processor", {"type": "Custom"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\p{Greek}"},
                       "behavior": "Isolated", "invert": False}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\h+"},
                       "behavior": "Isolated", "invert": False}),
])
def test_unknown_component_raises(tokenizers_dir, tmp_path, section,
                                  component):
    spec = json.loads((tokenizers_dir / "wordlevel" /
                       "tokenizer.json").read_text())
    spec[section] = component
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(UnsupportedTokenizer, match="tokenizer.json"):
        HfTokenizer(str(tmp_path))


def test_translated_classes_cover_non_bmp_text():
    import re

    letters = re.compile(translate_regex(r"\p{L}+"))
    numbers = re.compile(translate_regex(r"[^\s\p{L}]\p{N}+"))
    assert letters.fullmatch("𝐀𝐁𝐂日本語ñ")
    assert not letters.search("😀 ∑ 123")
    assert numbers.fullmatch("-٣𝟙2")  # Arabic-Indic and math digits
    assert not numbers.search("x٣")
    space = re.compile(translate_regex(r"\s+"))
    assert space.fullmatch("\t 　 \x85")
    assert not space.search("\x1c\x1d\x1e\x1f")  # not Unicode White_Space


def test_normalization_follows_python_unicodedata(tmp_path):
    """Code points assigned after the `tokenizers` package's tables were
    built normalize by Python's unicodedata here: U+107A7 (Unicode 14) has
    an NFKC decomposition that the package does not apply."""
    import unicodedata

    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>"))
    tok.normalizer = normalizers.NFKC()
    tok.decoder = decoders.Sequence([decoders.ByteFallback(),
                                     decoders.Fuse()])
    _train(tok, 300, ["<unk>"] + BYTE_FALLBACK)
    tok.save(str(tmp_path / "tokenizer.json"))
    ref, port = RefTokenizer(str(tmp_path)), HfTokenizer(str(tmp_path))
    text = "\U000107a7"
    normalized = unicodedata.normalize("NFKC", text)
    assert normalized != text
    assert port.encode(text) == ref.encode(normalized) != ref.encode(text)
    assert port.encode("⌅") == ref.encode("⌅")  # an older code point agrees
