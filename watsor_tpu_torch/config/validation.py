# Copy of watsor_tpu/config/validation.py: imports and paths adapted.
"""A compact declarative schema validator/normalizer.

The reference delegates config validation to the `cerberus` package
(upstream watsor/config/loader.py:140,190). This is a small clean-room
engine covering the rule vocabulary the watsor schema actually needs, with
error texts compatible with the reference's user-facing report (tests in the
reference assert on fragments like "required field" and "empty values not
allowed", see upstream watsor/test/test_config.py:33-37).

Schema mini-language (per-field spec keys):

- ``type``: one of 'integer', 'float', 'string', 'list', 'dict', 'boolean'
- ``coerce``: callable applied before validation (e.g. ``str``)
- ``default``: value inserted when field absent
- ``default_from_root``: key path into the root document whose (deep-copied)
  value is the default — replaces cerberus' custom ``default_setter``
- ``required``: field must be present
- ``nullable``: None allowed (default False when a type is given)
- ``empty``: empty containers/strings allowed (default True)
- ``min`` / ``max``: numeric bounds
- ``allowed``: value must be in the given collection
- ``dependencies``: other field (dotted path, rooted at document top) that
  must be present when this one is
- ``contains``: list must contain all the given values
- ``max_len``: maximum container length
- ``unique_key``: for lists of single-key dicts — keys must be unique
- ``items``: spec applied to every list element
- ``fields``: mapping of field name -> spec for dict values
- ``keys`` / ``values``: specs for dict keys / values (any key names)
"""

import copy


class SchemaError(ValueError):
    """Raised when a document does not satisfy the schema."""

    def __init__(self, errors):
        self.errors = list(errors)
        lines = ["Invalid configuration:"]
        lines.extend('\t"{}": {}'.format(path, msg) for path, msg in self.errors)
        super().__init__("\n".join(lines))


_TYPES = {
    'integer': (int,),
    'float': (int, float),
    'string': (str,),
    'boolean': (bool,),
    'list': (list,),
    'dict': (dict,),
}


def _type_ok(value, type_name):
    # bool is an int subclass, but `confidence: true` must not validate
    # as a numeric threshold (cerberus semantics)
    if type_name in ('integer', 'float') and isinstance(value, bool):
        return False
    return isinstance(value, _TYPES[type_name])


def _is_empty(value):
    return (isinstance(value, (str, list, dict)) and len(value) == 0)


def _lookup_path(document, dotted):
    node = document
    for part in dotted.split('.'):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


class Validator:
    """Validates and normalizes a document against a schema.

    ``validate`` returns the normalized deep copy of the document; errors are
    accumulated (not fail-fast) and raised together as :class:`SchemaError`.
    """

    def __init__(self, schema):
        self.schema = schema

    def validate(self, document):
        if not isinstance(document, dict):
            raise SchemaError([("", "document must be a mapping")])
        self._errors = []
        self._root = document
        normalized = self._normalize_dict(document, self.schema, path=())
        if self._errors:
            raise SchemaError(self._errors)
        return normalized

    # -- internals ---------------------------------------------------------

    def _error(self, path, message):
        self._errors.append((".".join(str(p) for p in path), message))

    def _normalize_dict(self, document, fields, path):
        out = {}
        for name, spec in fields.items():
            if name in document:
                out[name] = self._apply(document[name], spec, path + (name,))
            elif 'default' in spec:
                out[name] = self._apply(
                    copy.deepcopy(spec['default']), spec, path + (name,))
            elif 'default_from_root' in spec:
                root_val = _lookup_path(self._root, spec['default_from_root'])
                if root_val is None:
                    root_val = [] if spec.get('type') == 'list' else {}
                out[name] = self._apply(
                    copy.deepcopy(root_val), spec, path + (name,))
            elif spec.get('required'):
                self._error(path + (name,), "required field")
        for name in document:
            if name not in fields:
                self._error(path + (name,), "unknown field")
        # Dependency checks run against the *normalized* sibling document so
        # fields inherited from root defaults (e.g. a camera's ffmpeg block)
        # satisfy dependencies, matching cerberus' normalize-then-validate
        # ordering.
        for name, spec in fields.items():
            if name in out and 'dependencies' in spec:
                dep = spec['dependencies']
                if _lookup_path(out, dep) is None:
                    self._error(path + (name,),
                                "field '{}' is required".format(dep))
        return out

    def _apply(self, value, spec, path):
        if value is None:
            if spec.get('nullable'):
                return None
            # A typed field that is None: treat empty dict/list specs leniently
            # (YAML "- person:" yields None values), matching cerberus which
            # normalizes a None sub-document against its schema defaults.
            if spec.get('type') == 'dict' and ('fields' in spec or 'default' in spec):
                value = {}
            elif spec.get('type') == 'list' and 'default' in spec:
                value = copy.deepcopy(spec['default'])
            else:
                self._error(path, "null value not allowed")
                return None

        if 'coerce' in spec:
            try:
                value = spec['coerce'](value)
            except (TypeError, ValueError):
                self._error(path, "field could not be coerced")
                return value

        type_name = spec.get('type')
        if type_name is not None and not _type_ok(value, type_name):
            self._error(path, "must be of {} type".format(type_name))
            return value
        if type_name == 'float' and isinstance(value, int):
            value = float(value)

        if not spec.get('empty', True) and _is_empty(value):
            self._error(path, "empty values not allowed")
            return value

        if 'min' in spec and isinstance(value, (int, float)) and value < spec['min']:
            self._error(path, "min value is {}".format(spec['min']))
        if 'max' in spec and isinstance(value, (int, float)) and value > spec['max']:
            self._error(path, "max value is {}".format(spec['max']))

        if 'allowed' in spec and value not in spec['allowed']:
            self._error(path, "unallowed value {}".format(value))

        if 'max_len' in spec and isinstance(value, (list, dict)) and len(value) > spec['max_len']:
            self._error(path, "max length is {}".format(spec['max_len']))

        if 'contains' in spec and isinstance(value, list):
            missing = [v for v in spec['contains'] if v not in value]
            if missing:
                self._error(path, "missing members {}".format(missing))

        if isinstance(value, list):
            if spec.get('unique_key'):
                seen = set()
                for i, item in enumerate(value):
                    if isinstance(item, dict) and len(item) > 0:
                        key = next(iter(item))
                        if key in seen:
                            self._error(path + (i,), "'{}' is already defined".format(key))
                        seen.add(key)
            if 'items' in spec:
                value = [self._apply(item, spec['items'], path + (i,))
                         for i, item in enumerate(value)]

        if isinstance(value, dict):
            if 'fields' in spec:
                value = self._normalize_dict(value, spec['fields'], path)
            elif 'keys' in spec or 'values' in spec:
                out = {}
                for key, val in value.items():
                    if 'keys' in spec:
                        key = self._apply(key, spec['keys'], path + (key,))
                    if 'values' in spec:
                        val = self._apply(val, spec['values'], path + (key,))
                    out[key] = val
                value = out

        return value
