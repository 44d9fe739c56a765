"""Strict structural validation for every K8s manifest the port emits.

The port of ``tpuserve/provision/validate.py``: the same per-kind schemas,
written against the Kubernetes API types the manifests use, with
``additionalProperties: false`` at every level modeled — a misspelled
field name fails validation the way ``kubectl apply --validate=strict``
would reject it — plus the semantic cross-checks an API server or
controller enforces that pure schemas cannot express:

- workload ``selector.matchLabels`` must select the pod template's labels,
- every ``volumeMount`` must name a declared pod volume,
- container names must be unique within a pod,
- a probe's named port must exist among the container's ports,
- resource quantities must parse (``100Gi``, ``500m``, plain ints),
- a container that asks for ``nvidia.com/gpu`` names it in ``limits`` as
  a whole number, and any ``requests`` entry equals it (extended
  resources cannot be overcommitted or split).

The schemas are checked by a small Draft 2020-12 subset evaluator of its
own (``type``, ``properties``, ``additionalProperties``, ``required``,
``pattern``, ``enum``, ``const``, ``anyOf``, ``items``, the length and
range bounds): the keywords these schemas use, and no ``jsonschema``
package to install where a deploy runs.
"""

from __future__ import annotations

import re

GPU_RESOURCE = "nvidia.com/gpu"

DNS1123 = r"^[a-z0-9]([-a-z0-9.]*[a-z0-9])?$"
LABEL_VALUE = r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$|^$"
QUANTITY = r"^[0-9]+(\.[0-9]+)?(m|k|Ki|Mi|Gi|Ti|Pi|M|G|T|P|E)?$"

_str_map = {"type": "object",
            "additionalProperties": {"type": "string"}}

_metadata = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "pattern": DNS1123, "maxLength": 253},
        "namespace": {"type": "string", "pattern": DNS1123, "maxLength": 63},
        "labels": {"type": "object", "additionalProperties": {
            "type": "string", "pattern": LABEL_VALUE, "maxLength": 63}},
        "annotations": _str_map,
    },
    "required": ["name"],
    "additionalProperties": False,
}

_quantity = {"anyOf": [{"type": "string", "pattern": QUANTITY},
                       {"type": "integer", "minimum": 0}]}

_resources = {
    "type": "object",
    "properties": {
        "requests": {"type": "object", "additionalProperties": _quantity},
        "limits": {"type": "object", "additionalProperties": _quantity},
    },
    "additionalProperties": False,
}

_env_var = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "pattern": r"^[A-Za-z_][A-Za-z0-9_.]*$"},
        "value": {"type": "string"},
        "valueFrom": {
            "type": "object",
            "properties": {
                "fieldRef": {"type": "object",
                             "properties": {"fieldPath": {"type": "string"},
                                            "apiVersion": {"type": "string"}},
                             "required": ["fieldPath"],
                             "additionalProperties": False},
                "secretKeyRef": {"type": "object",
                                 "properties": {"name": {"type": "string"},
                                                "key": {"type": "string"},
                                                "optional": {"type": "boolean"}},
                                 "required": ["name", "key"],
                                 "additionalProperties": False},
                "configMapKeyRef": {"type": "object",
                                    "properties": {"name": {"type": "string"},
                                                   "key": {"type": "string"}},
                                    "required": ["name", "key"],
                                    "additionalProperties": False},
                "resourceFieldRef": {"type": "object",
                                     "properties": {
                                         "containerName": {"type": "string"},
                                         "resource": {"type": "string"},
                                         "divisor": _quantity},
                                     "required": ["resource"],
                                     "additionalProperties": False},
            },
            "additionalProperties": False,
        },
    },
    "required": ["name"],
    "additionalProperties": False,
}

_port_ref = {"anyOf": [{"type": "integer", "minimum": 1, "maximum": 65535},
                       {"type": "string", "pattern": DNS1123,
                        "maxLength": 15}]}

_probe = {
    "type": "object",
    "properties": {
        "httpGet": {"type": "object",
                    "properties": {"path": {"type": "string"},
                                   "port": _port_ref,
                                   "scheme": {"enum": ["HTTP", "HTTPS"]}},
                    "required": ["port"],
                    "additionalProperties": False},
        "tcpSocket": {"type": "object", "properties": {"port": _port_ref},
                      "required": ["port"], "additionalProperties": False},
        "exec": {"type": "object",
                 "properties": {"command": {"type": "array",
                                            "items": {"type": "string"}}},
                 "required": ["command"], "additionalProperties": False},
        "initialDelaySeconds": {"type": "integer", "minimum": 0},
        "periodSeconds": {"type": "integer", "minimum": 1},
        "timeoutSeconds": {"type": "integer", "minimum": 1},
        "failureThreshold": {"type": "integer", "minimum": 1},
        "successThreshold": {"type": "integer", "minimum": 1},
    },
    "additionalProperties": False,
}

_lifecycle_handler = {
    "type": "object",
    "properties": {
        "exec": _probe["properties"]["exec"],
        "httpGet": _probe["properties"]["httpGet"],
    },
    "additionalProperties": False,
}

_container = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "pattern": DNS1123, "maxLength": 63},
        "image": {"type": "string", "minLength": 1},
        "command": {"type": "array", "items": {"type": "string"}},
        "args": {"type": "array", "items": {"type": "string"}},
        "workingDir": {"type": "string"},
        "imagePullPolicy": {"enum": ["Always", "IfNotPresent", "Never"]},
        "ports": {"type": "array", "items": {
            "type": "object",
            "properties": {
                "containerPort": {"type": "integer", "minimum": 1,
                                  "maximum": 65535},
                "name": {"type": "string", "pattern": DNS1123,
                         "maxLength": 15},
                "protocol": {"enum": ["TCP", "UDP", "SCTP"]},
                "hostPort": {"type": "integer", "minimum": 1,
                             "maximum": 65535},
            },
            "required": ["containerPort"],
            "additionalProperties": False}},
        "env": {"type": "array", "items": _env_var},
        "volumeMounts": {"type": "array", "items": {
            "type": "object",
            "properties": {"name": {"type": "string"},
                           "mountPath": {"type": "string", "minLength": 1},
                           "subPath": {"type": "string"},
                           "readOnly": {"type": "boolean"}},
            "required": ["name", "mountPath"],
            "additionalProperties": False}},
        "resources": _resources,
        "readinessProbe": _probe,
        "livenessProbe": _probe,
        "startupProbe": _probe,
        "securityContext": {"type": "object"},
        "lifecycle": {
            "type": "object",
            "properties": {
                "preStop": _lifecycle_handler,
                "postStart": _lifecycle_handler,
            },
            "additionalProperties": False,
        },
    },
    "required": ["name", "image"],
    "additionalProperties": False,
}

_volume = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "pattern": DNS1123, "maxLength": 63},
        "persistentVolumeClaim": {"type": "object",
                                  "properties": {"claimName": {"type": "string"},
                                                 "readOnly": {"type": "boolean"}},
                                  "required": ["claimName"],
                                  "additionalProperties": False},
        "configMap": {"type": "object",
                      "properties": {"name": {"type": "string"},
                                     "items": {"type": "array"},
                                     "defaultMode": {"type": "integer"},
                                     "optional": {"type": "boolean"}},
                      "required": ["name"],
                      "additionalProperties": False},
        "emptyDir": {"type": "object",
                     "properties": {"medium": {"type": "string"},
                                    "sizeLimit": _quantity},
                     "additionalProperties": False},
        "hostPath": {"type": "object",
                     "properties": {"path": {"type": "string"},
                                    "type": {"type": "string"}},
                     "required": ["path"],
                     "additionalProperties": False},
        "secret": {"type": "object",
                   "properties": {"secretName": {"type": "string"},
                                  "optional": {"type": "boolean"}},
                   "required": ["secretName"],
                   "additionalProperties": False},
    },
    "required": ["name"],
    "additionalProperties": False,
}

_toleration = {
    "type": "object",
    "properties": {"key": {"type": "string"},
                   "operator": {"enum": ["Exists", "Equal"]},
                   "value": {"type": "string"},
                   "effect": {"enum": ["NoSchedule", "PreferNoSchedule",
                                       "NoExecute"]},
                   "tolerationSeconds": {"type": "integer"}},
    "additionalProperties": False,
}

_pod_spec = {
    "type": "object",
    "properties": {
        "containers": {"type": "array", "items": _container, "minItems": 1},
        "initContainers": {"type": "array", "items": _container},
        "volumes": {"type": "array", "items": _volume},
        "nodeSelector": _str_map,
        "tolerations": {"type": "array", "items": _toleration},
        "serviceAccountName": {"type": "string"},
        "restartPolicy": {"enum": ["Always", "OnFailure", "Never"]},
        "subdomain": {"type": "string", "pattern": DNS1123},
        "hostname": {"type": "string", "pattern": DNS1123},
        "hostNetwork": {"type": "boolean"},
        "terminationGracePeriodSeconds": {"type": "integer", "minimum": 0},
        "priorityClassName": {"type": "string"},
    },
    "required": ["containers"],
    "additionalProperties": False,
}

_pod_template = {
    "type": "object",
    "properties": {
        "metadata": {
            "type": "object",
            "properties": {"labels": _metadata["properties"]["labels"],
                           "annotations": _str_map,
                           "name": {"type": "string"}},
            "additionalProperties": False},
        "spec": _pod_spec,
    },
    "required": ["spec"],
    "additionalProperties": False,
}

_label_selector = {
    "type": "object",
    "properties": {"matchLabels": _str_map,
                   "matchExpressions": {"type": "array"}},
    "additionalProperties": False,
}

_service_port = {
    "type": "object",
    "properties": {"name": {"type": "string", "pattern": DNS1123,
                            "maxLength": 15},
                   "port": {"type": "integer", "minimum": 1,
                            "maximum": 65535},
                   "targetPort": _port_ref,
                   "nodePort": {"type": "integer"},
                   "protocol": {"enum": ["TCP", "UDP", "SCTP"]}},
    "required": ["port"],
    "additionalProperties": False,
}

_policy_rule = {
    "type": "object",
    "properties": {"apiGroups": {"type": "array", "items": {"type": "string"}},
                   "resources": {"type": "array", "items": {"type": "string"}},
                   "verbs": {"type": "array", "items": {"type": "string"},
                             "minItems": 1},
                   "nonResourceURLs": {"type": "array",
                                       "items": {"type": "string"}}},
    "required": ["verbs"],
    "additionalProperties": False,
}


def _top(api_version: str, spec: dict | None = None, *, required_spec=True,
         extra: dict | None = None, namespaced=True) -> dict:
    meta = dict(_metadata)
    if namespaced:
        meta = {**_metadata,
                "required": ["name", "namespace"]}
    props = {"apiVersion": {"const": api_version},
             "kind": {"type": "string"},
             "metadata": meta}
    required = ["apiVersion", "kind", "metadata"]
    if spec is not None:
        props["spec"] = spec
        if required_spec:
            required.append("spec")
    if extra:
        props.update(extra)
    return {"type": "object", "properties": props, "required": required,
            "additionalProperties": False}


SCHEMAS: dict[tuple[str, str], dict] = {
    ("v1", "Namespace"): _top("v1", None, namespaced=False),
    ("v1", "ConfigMap"): _top("v1", None, extra={"data": _str_map}),
    ("v1", "ServiceAccount"): _top("v1", None),
    ("v1", "Secret"): _top("v1", None, extra={
        "type": {"type": "string"},
        "stringData": _str_map,
        "data": _str_map,           # values must be base64; checked below
        "immutable": {"type": "boolean"}}),
    ("v1", "PersistentVolumeClaim"): _top("v1", {
        "type": "object",
        "properties": {
            "accessModes": {"type": "array", "items": {
                "enum": ["ReadWriteOnce", "ReadOnlyMany", "ReadWriteMany",
                         "ReadWriteOncePod"]}, "minItems": 1},
            "resources": {"type": "object",
                          "properties": {"requests": {
                              "type": "object",
                              "properties": {"storage": _quantity},
                              "required": ["storage"],
                              "additionalProperties": False}},
                          "required": ["requests"],
                          "additionalProperties": False},
            "storageClassName": {"type": "string"},
            "volumeMode": {"enum": ["Filesystem", "Block"]},
        },
        "required": ["accessModes", "resources"],
        "additionalProperties": False}),
    ("v1", "Service"): _top("v1", {
        "type": "object",
        "properties": {
            "type": {"enum": ["ClusterIP", "NodePort", "LoadBalancer",
                              "ExternalName"]},
            "clusterIP": {"type": ["string", "null"]},
            "selector": _str_map,
            "ports": {"type": "array", "items": _service_port},
            "publishNotReadyAddresses": {"type": "boolean"},
        },
        "additionalProperties": False}),
    ("batch/v1", "Job"): _top("batch/v1", {
        "type": "object",
        "properties": {
            "template": _pod_template,
            "backoffLimit": {"type": "integer", "minimum": 0},
            "ttlSecondsAfterFinished": {"type": "integer", "minimum": 0},
            "activeDeadlineSeconds": {"type": "integer", "minimum": 1},
            "completions": {"type": "integer", "minimum": 0},
            "parallelism": {"type": "integer", "minimum": 0},
        },
        "required": ["template"],
        "additionalProperties": False}),
    ("apps/v1", "Deployment"): _top("apps/v1", {
        "type": "object",
        "properties": {
            "replicas": {"type": "integer", "minimum": 0},
            "selector": _label_selector,
            "template": _pod_template,
            "strategy": {"type": "object"},
            "minReadySeconds": {"type": "integer"},
        },
        "required": ["selector", "template"],
        "additionalProperties": False}),
    ("apps/v1", "StatefulSet"): _top("apps/v1", {
        "type": "object",
        "properties": {
            "replicas": {"type": "integer", "minimum": 0},
            "selector": _label_selector,
            "template": _pod_template,
            "serviceName": {"type": "string", "pattern": DNS1123},
            "podManagementPolicy": {"enum": ["OrderedReady", "Parallel"]},
            "updateStrategy": {"type": "object"},
            "volumeClaimTemplates": {"type": "array"},
        },
        "required": ["selector", "template", "serviceName"],
        "additionalProperties": False}),
    ("apps/v1", "DaemonSet"): _top("apps/v1", {
        "type": "object",
        "properties": {
            "selector": _label_selector,
            "template": _pod_template,
            "updateStrategy": {"type": "object"},
        },
        "required": ["selector", "template"],
        "additionalProperties": False}),
    ("rbac.authorization.k8s.io/v1", "ClusterRole"): _top(
        "rbac.authorization.k8s.io/v1", None, namespaced=False,
        extra={"rules": {"type": "array", "items": _policy_rule}}),
    ("rbac.authorization.k8s.io/v1", "Role"): _top(
        "rbac.authorization.k8s.io/v1", None,
        extra={"rules": {"type": "array", "items": _policy_rule}}),
    ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"): _top(
        "rbac.authorization.k8s.io/v1", None, namespaced=False,
        extra={
            "roleRef": {"type": "object",
                        "properties": {"apiGroup": {"const":
                                       "rbac.authorization.k8s.io"},
                                       "kind": {"enum": ["ClusterRole",
                                                         "Role"]},
                                       "name": {"type": "string"}},
                        "required": ["apiGroup", "kind", "name"],
                        "additionalProperties": False},
            "subjects": {"type": "array", "items": {
                "type": "object",
                "properties": {"kind": {"enum": ["ServiceAccount", "User",
                                                 "Group"]},
                               "name": {"type": "string"},
                               "namespace": {"type": "string"},
                               "apiGroup": {"type": "string"}},
                "required": ["kind", "name"],
                "additionalProperties": False}},
        }),
    ("storage.k8s.io/v1", "StorageClass"): _top(
        "storage.k8s.io/v1", None, namespaced=False,
        extra={"provisioner": {"type": "string"},
               "volumeBindingMode": {"enum": ["Immediate",
                                              "WaitForFirstConsumer"]},
               "reclaimPolicy": {"enum": ["Delete", "Retain"]},
               "parameters": _str_map}),
    ("gateway.networking.k8s.io/v1", "Gateway"): _top(
        "gateway.networking.k8s.io/v1", {
            "type": "object",
            "properties": {
                "gatewayClassName": {"type": "string", "minLength": 1},
                "listeners": {"type": "array", "minItems": 1, "items": {
                    "type": "object",
                    "properties": {
                        "name": {"type": "string", "pattern": DNS1123},
                        "port": {"type": "integer", "minimum": 1,
                                 "maximum": 65535},
                        "protocol": {"enum": ["HTTP", "HTTPS", "TCP",
                                              "TLS", "UDP"]},
                        "hostname": {"type": "string"},
                        "allowedRoutes": {"type": "object"},
                        "tls": {"type": "object"},
                    },
                    "required": ["name", "port", "protocol"],
                    "additionalProperties": False}},
                "addresses": {"type": "array"},
            },
            "required": ["gatewayClassName", "listeners"],
            "additionalProperties": False}),
    ("gateway.networking.k8s.io/v1", "HTTPRoute"): _top(
        "gateway.networking.k8s.io/v1", {
            "type": "object",
            "properties": {
                "parentRefs": {"type": "array", "minItems": 1, "items": {
                    "type": "object",
                    "properties": {"name": {"type": "string"},
                                   "namespace": {"type": "string"},
                                   "sectionName": {"type": "string"},
                                   "kind": {"type": "string"},
                                   "group": {"type": "string"}},
                    "required": ["name"],
                    "additionalProperties": False}},
                "hostnames": {"type": "array", "items": {"type": "string"}},
                "rules": {"type": "array", "items": {
                    "type": "object",
                    "properties": {
                        "matches": {"type": "array", "items": {
                            "type": "object",
                            "properties": {
                                "path": {"type": "object",
                                         "properties": {
                                             "type": {"enum": [
                                                 "Exact", "PathPrefix",
                                                 "RegularExpression"]},
                                             "value": {"type": "string"}},
                                         "additionalProperties": False},
                                "headers": {"type": "array"},
                                "method": {"type": "string"},
                            },
                            "additionalProperties": False}},
                        "backendRefs": {"type": "array", "items": {
                            "type": "object",
                            "properties": {"name": {"type": "string"},
                                           "namespace": {"type": "string"},
                                           "port": {"type": "integer",
                                                    "minimum": 1,
                                                    "maximum": 65535},
                                           "weight": {"type": "integer"},
                                           "kind": {"type": "string"},
                                           "group": {"type": "string"}},
                            "required": ["name"],
                            "additionalProperties": False}},
                        "filters": {"type": "array"},
                    },
                    "additionalProperties": False}},
            },
            "required": ["parentRefs", "rules"],
            "additionalProperties": False}),
    ("monitoring.coreos.com/v1", "PrometheusRule"): _top(
        "monitoring.coreos.com/v1", {
            "type": "object",
            "properties": {
                "groups": {"type": "array", "minItems": 1, "items": {
                    "type": "object",
                    "properties": {
                        "name": {"type": "string"},
                        "interval": {"type": "string",
                                     "pattern": r"^[0-9]+(s|m|h)$"},
                        "rules": {"type": "array", "minItems": 1,
                                  "items": {
                            "type": "object",
                            "properties": {
                                "alert": {"type": "string"},
                                "record": {"type": "string"},
                                "expr": {"type": "string"},
                                "for": {"type": "string",
                                        "pattern": r"^[0-9]+(s|m|h)$"},
                                "labels": _str_map,
                                "annotations": _str_map,
                            },
                            "required": ["expr"],
                            "additionalProperties": False}},
                    },
                    "required": ["name", "rules"],
                    "additionalProperties": False}},
            },
            "required": ["groups"],
            "additionalProperties": False}),
    ("monitoring.coreos.com/v1", "ServiceMonitor"): _top(
        "monitoring.coreos.com/v1", {
            "type": "object",
            "properties": {
                "namespaceSelector": {
                    "type": "object",
                    "properties": {"matchNames": {"type": "array",
                                                  "items": {"type": "string"}},
                                   "any": {"type": "boolean"}},
                    "additionalProperties": False},
                "selector": _label_selector,
                "endpoints": {"type": "array", "items": {
                    "type": "object",
                    "properties": {"port": {"type": "string"},
                                   "path": {"type": "string"},
                                   "interval": {"type": "string",
                                                "pattern": r"^[0-9]+(s|m|h)$"},
                                   "scheme": {"type": "string"}},
                    "additionalProperties": False}, "minItems": 1},
            },
            "required": ["selector", "endpoints"],
            "additionalProperties": False}),
}

# RoleBinding shares ClusterRoleBinding's shape
SCHEMAS[("rbac.authorization.k8s.io/v1", "RoleBinding")] = {
    **SCHEMAS[("rbac.authorization.k8s.io/v1", "ClusterRoleBinding")]}


class ManifestError(ValueError):
    """A generated manifest a strict API server would reject."""


_TYPES = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "null": lambda v: v is None,
}


def schema_errors(schema: dict, obj, path: tuple = ()):
    """Yield ``(path, message)`` for each way ``obj`` breaks ``schema``
    (the keywords above; a keyword this evaluator lacks raises, so a
    schema cannot silently stop checking)."""
    known = {"type", "properties", "additionalProperties", "required",
             "pattern", "maxLength", "minLength", "enum", "const", "anyOf",
             "items", "minItems", "minimum", "maximum"}
    unknown = set(schema) - known
    if unknown:
        raise ValueError(f"schema keyword(s) {sorted(unknown)} not supported")
    if "anyOf" in schema:
        if not any(not any(True for _ in schema_errors(s, obj, path))
                   for s in schema["anyOf"]):
            yield path, f"{obj!r} is not valid under any of the given schemas"
            return
    if "const" in schema and obj != schema["const"]:
        yield path, f"{schema['const']!r} was expected"
    if "enum" in schema and obj not in schema["enum"]:
        yield path, f"{obj!r} is not one of {schema['enum']!r}"
    if "type" in schema:
        types = schema["type"]
        types = [types] if isinstance(types, str) else types
        if not any(_TYPES[t](obj) for t in types):
            yield path, f"{obj!r} is not of type {', '.join(map(repr, types))}"
            return
    if isinstance(obj, str):
        if "pattern" in schema and re.search(schema["pattern"], obj) is None:
            yield path, f"{obj!r} does not match {schema['pattern']!r}"
        if "maxLength" in schema and len(obj) > schema["maxLength"]:
            yield path, f"{obj!r} is too long"
        if "minLength" in schema and len(obj) < schema["minLength"]:
            yield path, f"{obj!r} is too short"
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            yield path, f"{obj!r} is less than the minimum of {schema['minimum']!r}"
        if "maximum" in schema and obj > schema["maximum"]:
            yield path, f"{obj!r} is greater than the maximum of {schema['maximum']!r}"
    if isinstance(obj, list):
        if "minItems" in schema and len(obj) < schema["minItems"]:
            yield path, f"{obj!r} should be non-empty"
        if "items" in schema:
            for i, item in enumerate(obj):
                yield from schema_errors(schema["items"], item, path + (i,))
    if isinstance(obj, dict):
        props = schema.get("properties", {})
        for key in schema.get("required", ()):
            if key not in obj:
                yield path, f"{key!r} is a required property"
        extra = schema.get("additionalProperties", True)
        for key, value in obj.items():
            if key in props:
                yield from schema_errors(props[key], value, path + (key,))
            elif extra is False:
                yield path, (f"Additional properties are not allowed "
                             f"({key!r} was unexpected)")
            elif isinstance(extra, dict):
                yield from schema_errors(extra, value, path + (key,))


def _ident(obj: dict) -> str:
    md = obj.get("metadata") or {}
    return (f"{obj.get('kind', '?')}/"
            f"{md.get('namespace', '-')}/{md.get('name', '?')}")


def _check_gpu_request(obj: dict, c: dict) -> None:
    """``nvidia.com/gpu`` is an extended resource: the device plugin hands
    out whole cards, so the API server requires it in ``limits`` as an
    integer and a ``requests`` entry, if any, equal to the limit."""
    res = c.get("resources") or {}
    limits, requests = res.get("limits") or {}, res.get("requests") or {}
    if GPU_RESOURCE not in limits and GPU_RESOURCE not in requests:
        return
    if GPU_RESOURCE not in limits:
        raise ManifestError(
            f"{_ident(obj)}: container {c['name']!r} requests "
            f"{GPU_RESOURCE} without a limit (extended resources are "
            "asked for in limits)")
    lim = str(limits[GPU_RESOURCE])
    if not lim.isdigit():
        raise ManifestError(
            f"{_ident(obj)}: container {c['name']!r} asks for "
            f"{GPU_RESOURCE}={lim!r}; cards are handed out whole")
    if GPU_RESOURCE in requests and str(requests[GPU_RESOURCE]) != lim:
        raise ManifestError(
            f"{_ident(obj)}: container {c['name']!r} requests "
            f"{requests[GPU_RESOURCE]!r} {GPU_RESOURCE} but limits {lim!r} "
            "(extended resources cannot be overcommitted)")


def _semantic_checks(obj: dict) -> None:
    kind = obj.get("kind")
    spec = obj.get("spec") or {}
    if kind in ("Deployment", "StatefulSet", "DaemonSet", "Job"):
        template = spec.get("template") or {}
        tmpl_labels = (template.get("metadata") or {}).get("labels") or {}
        match = (spec.get("selector") or {}).get("matchLabels") or {}
        if kind != "Job":          # Job selectors are controller-generated
            for k, v in match.items():
                if tmpl_labels.get(k) != v:
                    raise ManifestError(
                        f"{_ident(obj)}: selector.matchLabels {k}={v!r} does "
                        f"not select the pod template labels {tmpl_labels!r} "
                        "— the controller would never adopt its own pods")
        pod = template.get("spec") or {}
        volumes = {v["name"] for v in pod.get("volumes") or []}
        names = []
        for c in (pod.get("containers") or []) + (pod.get("initContainers")
                                                  or []):
            names.append(c["name"])
            port_names = {p.get("name") for p in c.get("ports") or []}
            for vm in c.get("volumeMounts") or []:
                if vm["name"] not in volumes:
                    raise ManifestError(
                        f"{_ident(obj)}: container {c['name']!r} mounts "
                        f"volume {vm['name']!r} which the pod does not "
                        f"declare (volumes: {sorted(volumes)})")
            for probe_key in ("readinessProbe", "livenessProbe",
                              "startupProbe"):
                probe = c.get(probe_key) or {}
                port = ((probe.get("httpGet") or {}).get("port")
                        or (probe.get("tcpSocket") or {}).get("port"))
                if isinstance(port, str) and port not in port_names:
                    raise ManifestError(
                        f"{_ident(obj)}: {probe_key} references port "
                        f"{port!r} but container {c['name']!r} declares "
                        f"ports {sorted(p for p in port_names if p)}")
            _check_gpu_request(obj, c)
        if len(names) != len(set(names)):
            raise ManifestError(
                f"{_ident(obj)}: duplicate container names {names}")
    if kind == "Secret":
        import base64
        for k, v in (obj.get("data") or {}).items():
            try:
                base64.b64decode(v, validate=True)
            except Exception:
                raise ManifestError(
                    f"{_ident(obj)}: data[{k!r}] is not valid base64 "
                    "(raw values belong in stringData)") from None
    if kind == "Service":
        ports = spec.get("ports") or []
        port_names = [p.get("name") for p in ports]
        if len(ports) > 1 and (None in port_names
                               or len(set(port_names)) != len(port_names)):
            raise ManifestError(
                f"{_ident(obj)}: multi-port Services need unique port names")


def validate_manifest(obj: dict) -> None:
    """Raise ManifestError if a strict API server would reject ``obj``."""
    if not isinstance(obj, dict):
        raise ManifestError(f"manifest must be a mapping, got {type(obj)}")
    key = (obj.get("apiVersion"), obj.get("kind"))
    schema = SCHEMAS.get(key)
    if schema is None:
        raise ManifestError(
            f"{_ident(obj)}: no vendored schema for apiVersion/kind {key} — "
            "add one to tpuserve_torch/provision/validate.py when emitting "
            "a new kind")
    errors = sorted(schema_errors(schema, obj), key=lambda e: list(map(str, e[0])))
    if errors:
        path, message = errors[0]
        path = ".".join(str(p) for p in path) or "<root>"
        raise ManifestError(f"{_ident(obj)}: {path}: {message}")
    _semantic_checks(obj)


def validate_all(objs: list[dict]) -> int:
    """Validate every manifest; returns the count (so callers can assert
    non-emptiness)."""
    for obj in objs:
        validate_manifest(obj)
    return len(objs)
