"""The port's safetensors reader and writer (cake_tpu_torch/utils/
safetensors_io.py) against the JAX package's: files written by JAX's
save_safetensors (bf16, f16, f32, int32; one file, and an index of two
shards) read by the port bit for bit in their stored dtype; files written
by the port read back by JAX's TensorStorage; a truncated file and a bad
header raise; an F8_E4M3 tensor reads as float8_e4m3fn with the JAX
reader's bytes, and an F8_E5M2 one raises."""
import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from cake_tpu.utils import safetensors_io as jst
from cake_tpu_torch.utils import safetensors_io as tst
from cake_tpu_torch.utils.export import write_checkpoint

TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16, "int32": torch.int32}


def _arrays(seed=0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "model.layers.0.self_attn.q_proj.weight":
            rng.normal(size=(6, 4)).astype(ml_dtypes.bfloat16),
        "model.layers.1.mlp.up_proj.weight":
            rng.normal(size=(3, 5)).astype(np.float16),
        "model.norm.weight": rng.normal(size=(7,)).astype(np.float32),
        "model.layers.1.ids": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "model.embed_tokens.weight":
            rng.normal(size=(9, 4)).astype(ml_dtypes.bfloat16),
        "odd.scalar": np.float32(3.5).reshape(()),
    }


def _same(t: torch.Tensor, a: np.ndarray) -> None:
    """t holds exactly a's bytes in a's dtype and shape."""
    assert t.dtype == TORCH_OF[np.dtype(a.dtype).name]
    assert tuple(t.shape) == a.shape
    assert t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() == \
        np.ascontiguousarray(a).tobytes()


def test_port_reads_jax_written_file(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "model.safetensors")
    jst.save_safetensors(path, arrays, {"format": "pt"})
    header, base = tst.read_header(path)
    assert (header, base) == jst.read_header(path)
    assert header["__metadata__"] == {"format": "pt"}
    with tst.TensorStorage.from_model_dir(str(tmp_path)) as st:
        assert set(st.names()) == set(arrays)
        for name, a in arrays.items():
            _same(st.read(name), a)
            assert st.records[name].nbytes == a.nbytes
        up = st.read("model.layers.0.self_attn.q_proj.weight",
                     dtype=torch.float32)
        assert up.dtype == torch.float32
        np.testing.assert_array_equal(
            up.numpy(), arrays["model.layers.0.self_attn.q_proj.weight"]
            .astype(np.float32))
        ids = st.read("model.layers.1.ids", dtype=torch.float32)
        assert ids.dtype == torch.int32        # integers are never cast


def test_port_reads_jax_written_shards(tmp_path):
    arrays = _arrays(1)
    names = sorted(arrays)
    halves = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    for fname, group in halves.items():
        jst.save_safetensors(str(tmp_path / fname),
                             {n: arrays[n] for n in group})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {n: f for f, g in halves.items() for n in g}}))
    # a stray file the index does not name is not read
    jst.save_safetensors(str(tmp_path / "stray.safetensors"),
                         {"stray": np.zeros(2, np.float32)})
    want = jst.TensorStorage.from_model_dir(str(tmp_path))
    with tst.TensorStorage.from_model_dir(str(tmp_path)) as st:
        assert set(st.names()) == set(want.names()) == set(arrays)
        for name in names:
            _same(st.read(name), want.read(name))
            assert tst.layer_of(name) == jst.layer_of(name)
    want.close()


def test_jax_reads_port_written_files(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tensors = {
        "a.bf16": torch.randn(5, 3, generator=gen).to(torch.bfloat16),
        "b.f16": torch.randn(4, generator=gen).to(torch.float16),
        "c.f32": torch.randn(2, 2, 2, generator=gen),
        "d.i32": torch.arange(-3, 3, dtype=torch.int32).reshape(2, 3),
        "e.view": torch.randn(6, 4, generator=gen)[:, 1],  # not contiguous
    }
    write_checkpoint(str(tmp_path), {"architectures": ["X"]}, tensors,
                     shards=2)
    index = json.loads((tmp_path / "model.safetensors.index.json")
                       .read_text())
    assert set(index["weight_map"]) == set(tensors)
    assert len(set(index["weight_map"].values())) == 2
    st = jst.TensorStorage.from_model_dir(str(tmp_path))
    for name, t in tensors.items():
        a = st.read(name)
        _same(t, a)
    st.close()
    with tst.TensorStorage.from_model_dir(str(tmp_path)) as port:
        for name, t in tensors.items():
            assert torch.equal(port.read(name), t)


def _write_raw(path, header: bytes, data: bytes = b"") -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + data)


def test_truncated_and_bad_files_raise(tmp_path):
    good = tmp_path / "good.safetensors"
    jst.save_safetensors(str(good), {"w": np.ones((64, 64), np.float32)})
    blob = good.read_bytes()
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(blob[:-100])
    with pytest.raises(ValueError, match="truncated"):
        tst.index_file(str(cut))
    short = tmp_path / "short.safetensors"
    short.write_bytes(blob[:20])
    with pytest.raises(ValueError, match="truncated header"):
        tst.read_header(str(short))
    tiny = tmp_path / "tiny.safetensors"
    tiny.write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="no header"):
        tst.read_header(str(tiny))
    bad = tmp_path / "bad.safetensors"
    _write_raw(bad, b"{not json}   ")
    with pytest.raises(ValueError, match="not JSON"):
        tst.read_header(str(bad))
    wrong = tmp_path / "wrong.safetensors"
    _write_raw(wrong, json.dumps({"w": {"dtype": "F32", "shape": [4],
                                        "data_offsets": [0, 12]}}).encode(),
               b"\0" * 12)
    with pytest.raises(ValueError, match="do not hold"):
        tst.index_file(str(wrong))
    fp8 = tmp_path / "fp8.safetensors"
    _write_raw(fp8, json.dumps({"w": {"dtype": "F8_E4M3", "shape": [4],
                                      "data_offsets": [0, 4]}}).encode(),
               bytes([0x38, 0xb8, 0x7f, 0x01]))
    assert tst.index_file(str(fp8))["w"].dtype == "F8_E4M3"
    got = tst.TensorStorage(tst.index_file(str(fp8))).read("w")
    assert got.dtype == torch.float8_e4m3fn
    assert got.view(torch.uint8).tolist() == [0x38, 0xb8, 0x7f, 0x01]
    assert got.float()[:2].tolist() == [1.0, -1.0]
    want = jst.TensorStorage(jst.index_file(str(fp8))).read("w")
    assert want.view(np.uint8).tolist() == [0x38, 0xb8, 0x7f, 0x01]
    e5m2 = tmp_path / "e5m2.safetensors"
    _write_raw(e5m2, json.dumps({"w": {"dtype": "F8_E5M2", "shape": [4],
                                       "data_offsets": [0, 4]}}).encode(),
               b"\0" * 4)
    with pytest.raises(NotImplementedError, match="F8_E5M2"):
        tst.index_file(str(e5m2))
    with pytest.raises(FileNotFoundError):
        tst.TensorStorage.from_model_dir(str(tmp_path / "nothing"))


def test_missing_tensor_raises_with_its_name(tmp_path):
    jst.save_safetensors(str(tmp_path / "model.safetensors"),
                         {"w": np.ones(2, np.float32)})
    with tst.TensorStorage.from_model_dir(str(tmp_path)) as st:
        with pytest.raises(KeyError, match="model.norm.weight"):
            st.read("model.norm.weight")
