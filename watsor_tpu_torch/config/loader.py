# Copy of watsor_tpu/config/loader.py: imports and paths adapted.
"""YAML configuration loading, validation and normalization.

Same public surface as the reference loader
(upstream watsor/config/loader.py:108-244):

- ``parse(filename=..., data=...)`` — YAML with ``!ENV "${VAR}"`` implicit
  interpolation, ``!env_var NAME default`` and ``!secret name`` (resolved
  from ``secrets.yaml`` searched upward through parent directories,
  HomeAssistant style).
- ``validate(config)`` — schema validation + defaulting; raises
  ``AssertionError`` on empty config and ``ValueError`` with an aggregated
  report on invalid config.
- ``normalize(config, path)`` — inserts the ffmpeg argv plumbing (program
  name, input after ``-i``, pipe placeholders, ``-s WxH`` for encoders,
  output target) and resolves relative mask paths.
"""

import logging
import os
import re

import yaml

from watsor_tpu_torch.config.schema import schema
from watsor_tpu_torch.config.validation import Validator

_LOGGER = logging.getLogger(__name__)

_ENV_PATTERN = re.compile(r'.*?\$\{(\w+)\}.*?')

SECRETS_YAML = "secrets.yaml"

_SECRET_CACHE = {}


def _load_yaml(filename, loader=yaml.SafeLoader):
    _LOGGER.debug("Loading %s", filename)
    with open(filename, encoding="utf-8") as stream:
        return yaml.load(stream, Loader=loader)


def _env_interpolate(loader, node):
    """Replace every ``${VAR}`` in the scalar with its environment value
    (leaving the bare variable name when unset)."""
    value = loader.construct_scalar(node)
    for var in _ENV_PATTERN.findall(value):
        value = value.replace('${%s}' % var, os.environ.get(var, var))
    return value


def _env_var(loader, node):
    """``!env_var NAME default...`` — environment variable with optional
    fallback; the environment wins when the variable is set, otherwise the
    remainder of the scalar is returned verbatim. Unset + no fallback is a
    configuration error."""
    parts = node.value.split(None, 1)     # internal spacing of the
    name = parts[0] if parts else ''      # fallback is preserved, the
    fallback = parts[1] if len(parts) > 1 else ''  # separator run is not
    value = os.environ.get(name)
    if value is not None:
        return value
    if fallback:
        return fallback
    raise ValueError(
        'environment variable "{}" is not set and the !env_var tag gave '
        'no default'.format(name))


def _read_secrets(filename):
    """Parse one ``secrets.yaml``, memoized for the duration of a single
    ``parse()`` call. A missing or empty file yields an empty mapping; a
    file whose top level is anything but a mapping is a config error."""
    cached = _SECRET_CACHE.get(filename)
    if cached is not None:
        return cached
    secrets = {}
    if os.path.isfile(filename):
        content = _load_yaml(filename)
        if isinstance(content, dict):
            secrets = content
        elif content is not None:
            raise ValueError(
                '{} must be a mapping of secret names to values'
                .format(filename))
    _SECRET_CACHE[filename] = secrets
    return secrets


def _candidate_secret_dirs(config_dir):
    """The config file's directory, then each ancestor — stopping near the
    filesystem root (a ``secrets.yaml`` in ``/`` was never intended for a
    camera config) or when the tree ends."""
    yield config_dir
    current = config_dir
    while True:
        parent = os.path.dirname(current)
        if parent == current or len(parent) < 5 or not os.path.exists(parent):
            return
        yield parent
        current = parent


def _secret(loader, node):
    """``!secret name`` — resolved from the nearest ``secrets.yaml`` found
    beside the config file or in any ancestor directory (HomeAssistant's
    search order)."""
    name = node.value
    config_dir = os.path.dirname(getattr(loader, 'name', '') or '')
    for directory in _candidate_secret_dirs(config_dir):
        store = _read_secrets(os.path.join(directory, SECRETS_YAML))
        if name in store:
            _LOGGER.debug('Secret "%s" found under %s', name, directory)
            return store[name]
    raise ValueError(
        'secret "{}" is missing from every secrets.yaml on the search '
        'path'.format(name))


class _ConfigLoader(yaml.SafeLoader):
    """Dedicated loader subclass so tag constructors don't leak into the
    global SafeLoader (the reference mutates SafeLoader globally; an isolated
    subclass is safer for a long-lived embedding process)."""


_ConfigLoader.add_implicit_resolver('!ENV', _ENV_PATTERN, None)
_ConfigLoader.add_constructor('!ENV', _env_interpolate)
_ConfigLoader.add_constructor('!env_var', _env_var)
_ConfigLoader.add_constructor('!secret', _secret)


def parse(filename=None, data=None):
    """Load a YAML configuration, resolving env vars and secrets.

    :param filename: path to the YAML file
    :param data: YAML text if no file is given
    :return: dict configuration (or None for empty input)
    """
    _SECRET_CACHE.clear()
    try:
        if filename:
            return _load_yaml(filename, loader=_ConfigLoader)
        elif data:
            return yaml.load(data, Loader=_ConfigLoader)
        raise ValueError('Either filename or data should be defined as input')
    finally:
        _SECRET_CACHE.clear()


def validate(config):
    """Validate a configuration against the schema and fill in defaults.

    :raises AssertionError: if config is None (empty file)
    :raises ValueError: aggregated per-field report if validation fails
    """
    assert config is not None, "Configuration file is empty"
    return Validator(schema).validate(config)


def normalize(config, path):
    """Insert ffmpeg argv plumbing and resolve relative mask paths.

    The decoder argv gains the program name, the input URL after ``-i`` and
    a trailing ``-`` (stdout pipe); the encoder argv gains the program name,
    ``-s WxH`` + stdin pipe before its ``-i``, and the output target (file
    path or ``-`` for broadcast). Mirrors the reference contract
    (upstream watsor/config/loader.py:206-244) so existing watsor
    YAML files work unchanged.
    """
    for camera in config['cameras']:
        camera_name = next(iter(camera))
        camera_config = camera[camera_name]
        ffmpeg = camera_config['ffmpeg']

        decoder = ffmpeg['decoder']
        decoder.insert(0, 'ffmpeg')
        decoder.insert(decoder.index('-i') + 1, camera_config['input'])
        decoder.append('-')

        encoder = ffmpeg.get('encoder')
        if encoder is not None:
            encoder.insert(0, 'ffmpeg')
            input_index = encoder.index('-i')
            size = '{}x{}'.format(camera_config['width'], camera_config['height'])
            encoder.insert(input_index, '-s')
            encoder.insert(input_index + 1, size)
            encoder.insert(input_index + 3, '-')
            encoder.append(camera_config.get('output', '-'))

        mask = camera_config.get('mask')
        if mask is not None and not os.path.isabs(mask):
            camera_config['mask'] = os.path.realpath(os.path.join(path, mask))

    return config
