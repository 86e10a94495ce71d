"""SARIF 2.1.0 rendering of findings (``lddl-analyze --format sarif``),
the port's copy of :mod:`lddl_tpu.analysis.sarif`: the same document.

SARIF is the interchange format CI systems (GitHub code scanning,
Azure DevOps, ...) ingest to render findings as inline annotations.
This writer emits the minimal conforming document: one run, the rule
table as ``tool.driver.rules``, one ``result`` per finding. Pragma-
suppressed findings are still emitted but carry an ``inSource``
suppression, so dashboards show them as reviewed rather than open.
Interprocedural findings render their call chain as a ``codeFlow``,
which viewers display as a step-through path to the effect site.
"""

SARIF_VERSION = '2.1.0'
_SCHEMA_URI = ('https://raw.githubusercontent.com/oasis-tcs/sarif-spec/'
               'master/Schemata/sarif-schema-2.1.0.json')


def _location(path, line, col=None, message=None):
  loc = {
      'physicalLocation': {
          'artifactLocation': {'uri': path},
          'region': {'startLine': max(1, line)},
      },
  }
  if col:
    loc['physicalLocation']['region']['startColumn'] = col
  if message:
    loc['message'] = {'text': message}
  return loc


def _code_flow(chain, label=None):
  flow = {
      'threadFlows': [{
          'locations': [
              {'location': _location(hop['path'], hop['line'],
                                     message=hop['name'])}
              for hop in chain
          ],
      }],
  }
  if label:
    flow['message'] = {'text': label}
  return flow


def to_sarif(findings, rules):
  """One SARIF 2.1.0 document (a JSON-ready dict) for ``findings``,
  with ``rules`` (per-file + project rule instances) as the driver's
  rule table."""
  rule_list = sorted(rules, key=lambda r: r.rule_id)
  rule_index = {r.rule_id: i for i, r in enumerate(rule_list)}
  results = []
  for f in findings:
    result = {
        'ruleId': f.rule_id,
        'level': 'error',
        'message': {'text': f.message},
        'locations': [_location(f.path, f.line, col=f.col)],
    }
    if f.rule_id in rule_index:
      result['ruleIndex'] = rule_index[f.rule_id]
    if f.suppressed:
      result['suppressions'] = [{'kind': 'inSource'}]
    if f.chains:
      # One codeFlow per labeled chain: a cross-thread finding shows the
      # writer's thread path and the reader's main path side by side.
      result['codeFlows'] = [_code_flow(c['hops'], label=c.get('label'))
                             for c in f.chains]
    elif f.chain:
      result['codeFlows'] = [_code_flow(f.chain)]
    results.append(result)
  return {
      '$schema': _SCHEMA_URI,
      'version': SARIF_VERSION,
      'runs': [{
          'tool': {
              'driver': {
                  'name': 'lddl-analyze',
                  'informationUri':
                      'https://github.com/NVIDIA/LDDL',
                  'rules': [{
                      'id': r.rule_id,
                      'name': r.name,
                      'shortDescription': {'text': r.invariant},
                      'help': {'text': r.hint},
                  } for r in rule_list],
              },
          },
          'results': results,
      }],
  }
