"""The port's one-command weight acquisition
(watsor_tpu_torch/models/fetch.py) against the JAX package's
(watsor_tpu/models/fetch.py), offline: the registry, checksum pinning,
archive safety, the refused download (a URL on this host's closed port)
and the ``--from-file`` install of a real TF checkpoint tarball (written
with TensorFlow where it is installed), whose ``.msgpack`` and provenance
sidecar equal the JAX fetch's."""

import hashlib
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from watsor_tpu.models import fetch as j_fetch
from watsor_tpu_torch.models.fetch import (REGISTRY, FetchError,
                                           _safe_extract, fetch, main,
                                           sha256_file)


def test_registry_is_the_jax_packages():
    assert REGISTRY == j_fetch.REGISTRY
    for name in ('ssd_mobilenet_v1', 'ssd_mobilenet_v2',
                 'ssdlite_mobilenet_v2', 'ssd_inception_v2',
                 'efficientdet_lite0', 'efficientdet_lite4'):
        assert name in REGISTRY


def test_unknown_model_is_a_clear_error(tmp_path):
    with pytest.raises(FetchError, match='unknown model'):
        fetch('nonexistent_model', str(tmp_path))


def test_checksum_mismatch_refuses_install(tmp_path):
    archive = tmp_path / 'weights.tar.gz'
    archive.write_bytes(b'not really weights')
    with pytest.raises(FetchError, match='checksum mismatch'):
        fetch('ssd_mobilenet_v2', str(tmp_path / 'out'), sha256='0' * 64,
              from_file=str(archive))
    assert not (tmp_path / 'out').exists()


def test_sha256_file_matches_hashlib(tmp_path):
    blob = tmp_path / 'blob'
    data = np.random.default_rng(0).bytes(3 * (1 << 20) + 17)
    blob.write_bytes(data)
    assert sha256_file(str(blob)) == hashlib.sha256(data).hexdigest() == \
        j_fetch.sha256_file(str(blob))


@pytest.mark.parametrize('member', ['traversal', 'symlink'])
def test_unsafe_archive_members_refused(tmp_path, member):
    """A member that escapes the destination, or any link member (one
    extracted first could redirect later members)."""
    evil = tmp_path / 'evil.tar'
    payload = tmp_path / 'payload'
    payload.write_bytes(b'x')
    with tarfile.open(evil, 'w') as tar:
        if member == 'traversal':
            tar.add(payload, arcname='../escape')
        else:
            link = tarfile.TarInfo('model_dir/link')
            link.type = tarfile.SYMTYPE
            link.linkname = '/etc'
            tar.addfile(link)
    with pytest.raises(FetchError, match='escapes destination'):
        _safe_extract(str(evil), str(tmp_path / 'out'))
    assert not (tmp_path / 'escape').exists()


def test_download_failure_is_fetch_error(tmp_path):
    registry = {'model_x': ('http://127.0.0.1:1/nothing.tar.gz',
                            '.index', None)}
    with pytest.raises(FetchError, match='download failed'):
        fetch('model_x', str(tmp_path), registry=registry)


def test_cli_maps_errors_to_exit_code(tmp_path, capsys):
    assert main(['nonexistent_model', '-o', str(tmp_path)]) == 1
    assert 'unknown model' in capsys.readouterr().err


@pytest.fixture(scope='module')
def checkpoint_archive(tmp_path_factory):
    """A published-style tarball (model_dir/model.ckpt.*) of a seeded
    width-0.35 SSD-MobileNetV2 checkpoint with 3 classes."""
    pytest.importorskip('tensorflow')
    from tests.test_convert_head import _write_checkpoint
    from watsor_tpu_torch.models.ssd import SSDConfig, build_detector
    from watsor_tpu_torch.testing.slim import tf_od_variables
    from test_torch_convert import _seeded
    cfg = SSDConfig(num_classes=3, width_multiplier=0.35)
    tree = _seeded(build_detector(cfg._replace(dtype=torch.float32),
                                  device='cpu').variables,
                   np.random.default_rng(3))
    root = tmp_path_factory.mktemp('fetch')
    (root / 'model_dir').mkdir()
    _write_checkpoint(tf_od_variables(tree, cfg),
                      str(root / 'model_dir' / 'model.ckpt'))
    archive = root / 'ssd_test.tar.gz'
    with tarfile.open(archive, 'w:gz') as tar:
        tar.add(root / 'model_dir', arcname='model_dir')
    return str(archive)


REGISTRY_ENTRY = {'ssd_test': ('http://unused.example/ssd_test.tar.gz',
                               'model.ckpt.index', None)}


def test_from_file_installs_as_the_jax_fetch(checkpoint_archive, tmp_path):
    """``--from-file``: the same ``.msgpack`` bytes and the same provenance
    (no URL, the archive's name and digest, the artifact's path in the
    archive) as the JAX package's fetch; pinning the recorded digest
    reproduces the install."""
    got = fetch('ssd_test', str(tmp_path / 'port'),
                from_file=checkpoint_archive, registry=REGISTRY_ENTRY)
    want = j_fetch.fetch('ssd_test', str(tmp_path / 'jax'),
                         from_file=checkpoint_archive,
                         registry=REGISTRY_ENTRY)
    assert got == want
    assert got['source_url'] is None
    assert got['archive_sha256'] == sha256_file(checkpoint_archive)
    assert got['artifact'] == os.path.join('model_dir', 'model.ckpt')
    for name in ('ssd_test.msgpack', 'ssd_test.provenance.json'):
        with open(tmp_path / 'port' / name, 'rb') as a, \
                open(tmp_path / 'jax' / name, 'rb') as b:
            assert a.read() == b.read()
    with open(tmp_path / 'port' / 'ssd_test.provenance.json') as f:
        assert json.load(f) == got
    again = fetch('ssd_test', str(tmp_path / 'port'),
                  from_file=checkpoint_archive,
                  sha256=got['archive_sha256'], registry=REGISTRY_ENTRY)
    assert again == got


def test_cli_from_file(checkpoint_archive, tmp_path, capsys, monkeypatch):
    """``watsor-tpu-torch-fetch <model> -o DIR --from-file ARCHIVE`` exits 0
    and names the install."""
    import watsor_tpu_torch.models.fetch as fetch_module
    monkeypatch.setattr(fetch_module, 'REGISTRY', REGISTRY_ENTRY)
    out = str(tmp_path / 'model')
    assert main(['ssd_test', '-o', out, '--from-file',
                 checkpoint_archive]) == 0
    assert 'installed ssd_test -> {}'.format(out) in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, 'ssd_test.msgpack'))
