# Copy of watsor_tpu/models/fetch.py: imports and paths adapted.
"""One-command weight acquisition: download + verify + convert + install.

The reference ships model files inside its Docker images; here the weights
come from the same public sources but are converted into the zoo's native
format on the operator's machine:

    python -m watsor_tpu_torch.models.fetch ssd_mobilenet_v2 \
        -o /usr/share/watsor/model

Downloads the published archive, verifies its SHA-256 against the pin (or
prints + records it on first use), extracts the checkpoint/graph, runs the
watsor_tpu_torch.models.convert CLI on it, and writes a provenance sidecar
(<name>.provenance.json: source URL, archive digest, artifact) next to the
weights. ``--from-file`` skips the download for hosts with no network.
Converting needs TensorFlow (the checkpoint and flatbuffer readers).
"""

import argparse
import hashlib
import json
import os
import shutil
import sys
import tarfile
import tempfile


class FetchError(RuntimeError):
    pass


# model name -> (archive URL, member suffix to locate inside the archive,
# pinned sha256 or None = trust-on-first-use with the digest recorded)
REGISTRY = {
    # TF Object Detection API zoo: the checkpoints behind the reference's
    # gpu.uff / cpu.pb exports
    'ssd_mobilenet_v1': (
        'http://download.tensorflow.org/models/object_detection/'
        'ssd_mobilenet_v1_coco_2018_01_28.tar.gz',
        'model.ckpt.index', None),
    'ssd_mobilenet_v2': (
        'http://download.tensorflow.org/models/object_detection/'
        'ssd_mobilenet_v2_coco_2018_03_29.tar.gz',
        'model.ckpt.index', None),
    'ssdlite_mobilenet_v2': (
        'http://download.tensorflow.org/models/object_detection/'
        'ssdlite_mobilenet_v2_coco_2018_05_09.tar.gz',
        'model.ckpt.index', None),
    'ssd_inception_v2': (
        'http://download.tensorflow.org/models/object_detection/'
        'ssd_inception_v2_coco_2018_01_28.tar.gz',
        'model.ckpt.index', None),
    # the reference's own CPU model file (the Coral-published TFLite graph
    # its Docker image downloads)
    'ssd_mobilenet_v2_tflite': (
        'https://github.com/google-coral/test_data/raw/master/'
        'ssd_mobilenet_v2_coco_quant_postprocess.tflite',
        '.tflite', None),
    # automl EfficientDet-Lite checkpoints (converted by
    # models/convert_effdet.py geometry inference)
    'efficientdet_lite0': (
        'https://storage.googleapis.com/cloud-tpu-checkpoints/efficientdet/'
        'coco/efficientdet-lite0.tgz', '.index', None),
    'efficientdet_lite1': (
        'https://storage.googleapis.com/cloud-tpu-checkpoints/efficientdet/'
        'coco/efficientdet-lite1.tgz', '.index', None),
    'efficientdet_lite2': (
        'https://storage.googleapis.com/cloud-tpu-checkpoints/efficientdet/'
        'coco/efficientdet-lite2.tgz', '.index', None),
    'efficientdet_lite3': (
        'https://storage.googleapis.com/cloud-tpu-checkpoints/efficientdet/'
        'coco/efficientdet-lite3.tgz', '.index', None),
    'efficientdet_lite4': (
        'https://storage.googleapis.com/cloud-tpu-checkpoints/efficientdet/'
        'coco/efficientdet-lite4.tgz', '.index', None),
}


def sha256_file(path, chunk=1 << 20):
    digest = hashlib.sha256()
    with open(path, 'rb') as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            digest.update(data)
    return digest.hexdigest()


def download(url, dest, progress=True):
    import urllib.request
    try:
        with urllib.request.urlopen(url) as response, \
                open(dest, 'wb') as out:
            total = int(response.headers.get('Content-Length') or 0)
            done = 0
            while True:
                data = response.read(1 << 20)
                if not data:
                    break
                out.write(data)
                done += len(data)
                if progress and total:
                    print('\r  {:.0f}%'.format(100.0 * done / total),
                          end='', file=sys.stderr, flush=True)
            if progress:
                print(file=sys.stderr)
    except OSError as exc:
        raise FetchError('download failed: {} ({})'.format(url, exc))


def _safe_extract(archive, dest):
    """Extract a tarball refusing path traversal AND link members (a
    symlink extracted first could redirect later members outside dest —
    the realpath pre-scan alone can't see that)."""
    with tarfile.open(archive) as tar:
        for member in tar.getmembers():
            if member.issym() or member.islnk():
                raise FetchError(
                    'archive member escapes destination: ' + member.name)
            target = os.path.realpath(os.path.join(dest, member.name))
            root = os.path.realpath(dest)
            if target != root and not target.startswith(root + os.sep):
                # ('.'/'./' members resolve to the root itself: legal)
                raise FetchError(
                    'archive member escapes destination: ' +
                    member.name)
        try:
            tar.extractall(dest, filter='data')   # py>=3.12 hardening
        except TypeError:
            tar.extractall(dest)


def _locate(root, suffix):
    """Find the artifact inside an extracted tree (by filename suffix)."""
    hits = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(suffix):
                hits.append(os.path.join(dirpath, name))
    if not hits:
        raise FetchError(
            'no *{} found in the downloaded archive'.format(suffix))
    hits.sort(key=len)
    return hits[0]


def fetch(model, output, sha256=None, from_file=None, registry=None):
    """Returns the provenance dict after installing <model> weights into
    ``output``. ``from_file`` uses a pre-downloaded archive/graph."""
    registry = registry if registry is not None else REGISTRY
    if model not in registry:
        raise FetchError('unknown model {!r}; choose from: {}'.format(
            model, ', '.join(sorted(registry))))
    url, suffix, pinned = registry[model]
    expected = sha256 or pinned

    workdir = tempfile.mkdtemp(prefix='watsor-fetch-')
    try:
        archive = from_file
        if archive is None:
            archive = os.path.join(workdir, os.path.basename(url))
            print('fetching {}'.format(url), file=sys.stderr)
            download(url, archive)
        digest = sha256_file(archive)
        if expected and digest != expected:
            raise FetchError(
                'checksum mismatch for {}: expected {}, got {}'.format(
                    os.path.basename(archive), expected, digest))
        if not expected:
            print('sha256 {} (recorded in provenance; pin it with '
                  '--sha256 for reproducible installs)'.format(digest),
                  file=sys.stderr)

        if archive.endswith(('.tar.gz', '.tgz', '.tar')):
            _safe_extract(archive, workdir)
            artifact = _locate(workdir, suffix)
            if artifact.endswith('.index'):
                artifact = artifact[:-len('.index')]  # ckpt prefix
        else:
            artifact = archive

        from watsor_tpu_torch.models import convert
        convert.main(['-c', artifact, '-o', output, '-n', model])

        provenance = {
            'model': model,
            'source_url': None if from_file else url,
            'source_file': os.path.basename(archive),
            'archive_sha256': digest,
            'artifact': os.path.relpath(artifact, workdir)
            if artifact.startswith(workdir) else os.path.basename(artifact),
        }
        with open(os.path.join(output,
                               model + '.provenance.json'), 'w') as f:
            json.dump(provenance, f, indent=2)
        return provenance
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Download, verify and convert public detector weights '
                    'in one command')
    parser.add_argument('model', help='zoo model name ({})'.format(
        ', '.join(sorted(REGISTRY))))
    parser.add_argument('-o', '--output', default='/usr/share/watsor/model',
                        help='model directory (default %(default)s)')
    parser.add_argument('--sha256', default=None,
                        help='pin the archive digest')
    parser.add_argument('--from-file', default=None,
                        help='use a pre-downloaded archive / .tflite '
                             '(air-gapped hosts)')
    args = parser.parse_args(argv)
    try:
        provenance = fetch(args.model, args.output, sha256=args.sha256,
                           from_file=args.from_file)
    except FetchError as exc:
        print('error: {}'.format(exc), file=sys.stderr)
        return 1
    print('installed {} -> {} (sha256 {})'.format(
        args.model, args.output, provenance['archive_sha256']))
    return 0


if __name__ == '__main__':
    sys.exit(main())
