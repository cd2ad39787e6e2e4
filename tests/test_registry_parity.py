"""Registry completeness audit vs the upstream public_configs.

The reference registry (``public_benchmark/public_configs.py``) is pure
Python dicts with no third-party imports, so it is imported DIRECTLY and
compared key-by-key and field-by-field against
``weatherbenchx_tpu.apps.configs`` (VERDICT r2 item 6).

Waivers (documented divergences, checked to stay true):
  * climatology_configs: the repo adds unversioned ``era5_<res>`` aliases
    on top of the reference's year-keyed entries — a superset.
  * There is no plain ``era5`` *prediction* entry in the reference either
    (``era5_forecast`` is ERA5's own forecasts; ERA5-as-truth enters as
    target/persistence/probabilistic_climatology, which the CLI handles
    via the special prediction kinds, reference
    ``run_benchmark_evaluation.py:151-201``).
"""

import os
import sys

import pytest

REF_PB = os.path.join(
    os.environ.get('WBX_REFERENCE_ROOT', '/root/reference'),
    'public_benchmark')

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_PB), reason='reference tree not available')


@pytest.fixture(scope='module')
def ref_configs():
  sys.path.insert(0, REF_PB)
  try:
    import public_configs
    return public_configs
  finally:
    sys.path.remove(REF_PB)


@pytest.fixture(scope='module')
def wbx_configs():
  from weatherbenchx_tpu.apps import configs
  return configs


REGISTRIES = ['deterministic_prediction_configs',
              'probabilistic_prediction_configs',
              'single_member_configs',
              'target_configs',
              'climatology_configs']


class TestRegistryParity:

  @pytest.mark.parametrize('name', REGISTRIES)
  def test_every_reference_key_present(self, ref_configs, wbx_configs, name):
    ref = getattr(ref_configs, name)
    ref = ref() if callable(ref) else ref
    wbx = getattr(wbx_configs, name)
    wbx = wbx() if callable(wbx) else wbx
    missing = sorted(set(ref) - set(wbx))
    assert not missing, f'{name}: reference keys missing from repo: {missing}'

  @pytest.mark.parametrize('name', REGISTRIES)
  def test_no_phantom_keys(self, ref_configs, wbx_configs, name):
    ref = getattr(ref_configs, name)
    ref = ref() if callable(ref) else ref
    wbx = getattr(wbx_configs, name)
    wbx = wbx() if callable(wbx) else wbx
    extra = sorted(set(wbx) - set(ref))
    if name == 'climatology_configs':
      # Waiver: unversioned aliases era5_<res> (see module docstring), and
      # 2016 entries for all resolutions (the reference only lists
      # era5_240x121_2016; the repo generates the same published
      # 1990-2017 path pattern for the other grids too — a superset).
      extra = [k for k in extra
               if k.count('_') != 1 and not k.endswith('_2016')]
    assert not extra, f'{name}: repo keys not in reference: {extra}'

  @pytest.mark.parametrize('name', REGISTRIES)
  def test_entry_fields_match(self, ref_configs, wbx_configs, name):
    ref = getattr(ref_configs, name)
    ref = ref() if callable(ref) else ref
    wbx = getattr(wbx_configs, name)
    wbx = wbx() if callable(wbx) else wbx
    for key, ref_entry in ref.items():
      wbx_entry = wbx[key]
      assert wbx_entry.get('path') == ref_entry.get('path'), (
          name, key, 'path')
      if 'variables' in ref_entry:
        assert sorted(wbx_entry.get('variables', [])) == sorted(
            ref_entry['variables']), (name, key, 'variables')
      if 'levels' in ref_entry:
        assert list(wbx_entry.get('levels', [])) == list(
            ref_entry['levels']), (name, key, 'levels')
      ref_dlk = ref_entry.get('data_loader_kwargs', {})
      wbx_dlk = wbx_entry.get('data_loader_kwargs', {})
      for field in ('rename_dimensions', 'rename_variables',
                    'add_nan_mask'):
        if field in ref_dlk:
          assert field in wbx_dlk, (name, key, field)
          assert wbx_dlk[field] == ref_dlk[field], (name, key, field)

  def test_special_prediction_kinds_supported(self):
    """The CLI handles the loader-dispatch prediction names the reference
    does (run_benchmark_evaluation.py:151-201)."""
    import inspect

    from weatherbenchx_tpu.apps import run_benchmark_evaluation as cli
    src = inspect.getsource(cli.main)
    for kind in ('persistence', 'climatology', 'probabilistic_climatology'):
      assert f"'{kind}'" in src, f'CLI missing special prediction {kind!r}'

  def test_per_model_quirks_mirrored(self):
    """Default init-time quirks (fuxi/excarta/aurora/baguan/2022) exist."""
    import inspect

    from weatherbenchx_tpu.apps import run_benchmark_evaluation as cli
    src = inspect.getsource(cli.main)
    for marker in ('fuxi', 'excarta', 'aurora', 'baguan', '12-16',
                   '12-30T12'):
      assert marker in src, f'CLI missing reference quirk {marker!r}'


def test_model_display_names_cover_reference():
  """Every reference combine_results display-name key exists here too."""
  import re

  from weatherbenchx_tpu.apps import combine_results as cr

  src_path = os.path.join(REF_PB, 'combine_results.py')
  if not os.path.exists(src_path):
    pytest.skip('reference combine_results not available')
  src = open(src_path).read()
  ref_keys = set(re.findall(r'"([a-z0-9_]+_vs_[a-z0-9_]+)":', src))
  missing = sorted(ref_keys - set(cr.MODEL_NAMES))
  assert not missing, missing
