"""Categorical metrics: confusion-matrix family, SEEPS, CDF-based RPS.

Reference semantics: ``weatherbenchX/metrics/categorical.py:25-971``.
"""

from typing import Hashable, Mapping, Sequence, Union, final

import numpy as np

from weatherbenchx_tpu import darray
from weatherbenchx_tpu.darray import Coord, DimArray
from weatherbenchx_tpu.metrics import base
from weatherbenchx_tpu.metrics import wrappers


def _nan_mask_product(predictions: DimArray, targets: DimArray) -> DimArray:
  return ~(predictions * targets).isnull()


class TruePositives(base.PerVariableStatistic):
  """pred AND target, NaN-propagating, float32."""

  def _compute_per_variable(self, predictions, targets):
    return (predictions.astype(bool) & targets.astype(bool)).where(
        _nan_mask_product(predictions, targets)).astype(np.float32)


class TrueNegatives(base.PerVariableStatistic):
  """NOT pred AND NOT target."""

  def _compute_per_variable(self, predictions, targets):
    return ((~predictions.astype(bool)) & (~targets.astype(bool))).where(
        _nan_mask_product(predictions, targets)).astype(np.float32)


class FalsePositives(base.PerVariableStatistic):
  """pred AND NOT target."""

  def _compute_per_variable(self, predictions, targets):
    return (predictions.astype(bool) & (~targets.astype(bool))).where(
        _nan_mask_product(predictions, targets)).astype(np.float32)


class FalseNegatives(base.PerVariableStatistic):
  """NOT pred AND target."""

  def _compute_per_variable(self, predictions, targets):
    return ((~predictions.astype(bool)) & targets.astype(bool)).where(
        _nan_mask_product(predictions, targets)).astype(np.float32)


class SEEPS(base.StatisticWithClimatology):
  """Stable Equitable Error in Probability Space (Rodwell et al. 2010).

  Spec: reference ``categorical.py:104-304`` — precipitation is classified
  into dry/light/heavy categories against a climatological wet threshold
  aligned at each valid time; a 3×3 scoring matrix built from the
  climatological dry fraction p1 scores the (forecast, truth) category
  pair; p1 outside [min_p1, max_p1] is masked (requires masked=True
  aggregation).

  The compute shape here is deliberately not the reference's: instead of
  stacking per-category indicator arrays, forming the 9-cell contingency
  outer product, and contracting it against a concatenated scoring-matrix
  DataArray, the score is one fused elementwise pass — six boolean
  category-pair selects, each multiplying its scoring-cell expression
  (evaluated with the exact arithmetic of the reference's matrix entries,
  so values stay bit-identical). No category axis, no concat/rename, no
  contraction: a single elementwise fusion with 1/9th the intermediate
  footprint. Degenerate inputs keep reference semantics: a NaN wet
  threshold leaves a non-dry point in no category (score contribution 0,
  not NaN), and NaN precipitation poisons its gridpoint.
  """

  def __init__(
      self,
      variables: Sequence[str],
      climatology: Mapping[Hashable, DimArray],
      dry_threshold_mm: Union[float, Sequence[float]] = 0.25,
      min_p1: Union[float, Sequence[float]] = 0.1,
      max_p1: Union[float, Sequence[float]] = 0.85,
  ):
    super().__init__(climatology)
    self._variables = list(variables)
    n = len(self._variables)
    self._dry_threshold_mm = (
        list(dry_threshold_mm) if isinstance(dry_threshold_mm, Sequence)
        else [dry_threshold_mm] * n)
    self._min_p1 = list(min_p1) if isinstance(min_p1, Sequence) else [
        min_p1] * n
    self._max_p1 = list(max_p1) if isinstance(max_p1, Sequence) else [
        max_p1] * n
    assert len(self._variables) == len(self._dry_threshold_mm) == len(
        self._min_p1) == len(self._max_p1), (
            'All arguments must have the same length.')
    # p1 (the climatological dry fraction averaged over its time dims) is
    # constant across the whole evaluation, so precompute it host-side
    # once instead of shipping the full (dayofyear, hour, lat, lon) dry-
    # fraction array to the device and re-averaging it per chunk — at
    # production 0.25 degrees that array is ~2.4 GB/variable of HBM for a
    # value that never changes.
    self._p1 = {}
    for variable in self._variables:
      df = self._climatology[f'{variable}_seeps_dry_fraction']
      tdims = tuple(
          d for d in ('hour', 'dayofyear', 'time') if d in df.dims)
      self._p1[variable] = df.mean(tdims) if tdims else df

  @property
  def unique_name(self) -> str:
    suffix = ('_'.join(self._variables)
              + '_dry_threshold_mm_'
              + '_'.join(str(s) for s in self._dry_threshold_mm)
              + '_min_p1_' + '_'.join(str(s) for s in self._min_p1)
              + '_max_p1_' + '_'.join(str(s) for s in self._max_p1))
    return f'SEEPS_{suffix}'

  def device_resource_arrays(self):
    """Wet thresholds + precomputed p1 — NOT the raw dry-fraction array
    (p1 replaces it; see __init__)."""
    out = {}
    for variable in self._variables:
      thr = self._climatology[f'{variable}_seeps_threshold']
      out[base.resource_id(thr)] = thr.data
      p1 = self._p1[variable]
      out[base.resource_id(p1)] = p1.data
    return out

  def host_gatherable_resource_arrays(self):
    """Only the wet thresholds are consumed via alignment; p1 is used
    directly in compute and must stay resident (it is small)."""
    return {
        base.resource_id(self._climatology[f'{v}_seeps_threshold']):
            self._climatology[f'{v}_seeps_threshold']
        for v in self._variables}

  def _aligned_clim_keys(self, var):
    return (f'{var}_seeps_threshold',) if var in self._variables else ()

  def compute(self, predictions, targets):
    out = {}
    for variable, dry_mm, min_p1, max_p1 in zip(
        self._variables, self._dry_threshold_mm, self._min_p1, self._max_p1):
      out[variable] = self._scored_variable(
          predictions[variable], targets[variable], variable, dry_mm,
          min_p1, max_p1)
    return out

  @staticmethod
  def _rain_bands(da: DimArray, wet: DimArray, dry_mm: float):
    """(dry, light, heavy) boolean bands for one side.

    Bands follow the spec exactly: a NaN wet threshold puts a non-dry
    point in NO band (comparisons with NaN are False), so its score
    contribution is 0 rather than NaN — NaN data itself is poisoned
    separately by the caller.
    """
    lo = dry_mm / 1000.0  # mm → SI meters
    return da <= lo, (da > lo) & (da < wet), da >= wet

  def _scored_variable(
      self, predictions: DimArray, targets: DimArray, variable: str,
      dry_mm: float, min_p1: float, max_p1: float) -> DimArray:
    wet = base.aligned_climatology_for(
        self.clim(f'{variable}_seeps_threshold'), predictions)
    f_dry, f_light, f_heavy = self._rain_bands(predictions, wet, dry_mm)
    t_dry, t_light, t_heavy = self._rain_bands(targets, wet, dry_mm)

    p1 = base.resolve_resource(self._p1[variable])

    # Fused select-sum over the six nonzero cells of the Rodwell scoring
    # matrix (entry expressions verbatim from the spec so each selected
    # value is bit-identical to the reference's matrix-then-dot route; at
    # most one select fires per gridpoint, and halving afterwards is an
    # exact fp op, so the order change is lossless).
    score = 0.5 * (
        (f_dry & t_light) * (1 / (1 - p1))
        + (f_dry & t_heavy) * (4 / (1 - p1))
        + (f_light & t_dry) * (1 / p1)
        + (f_light & t_heavy) * (3 / (1 - p1))
        + (f_heavy & t_dry) * (1 / p1 + 3 / (2 + p1))
        + (f_heavy & t_light) * (3 / (2 + p1)))

    # NaN data poisons its own gridpoint (the reference routes this
    # through float-NaN category stacks; here it is one explicit where).
    result = score.where(~(predictions.isnull() | targets.isnull()))

    # Mask out p1 outside [min_p1, max_p1].
    mask = (p1 >= min_p1) & (p1 <= max_p1)
    result = result.where(mask, np.nan)

    if predictions.has_coord('mask') and targets.has_coord('mask'):
      raise ValueError(
          'SEEPS expects at most one side to carry a nan-mask coord; got '
          'masks on both predictions and targets')
    for side in (predictions, targets):
      if side.has_coord('mask'):
        mask = mask & DimArray(side.coords['mask'].values,
                               side.coords['mask'].dims)
    mask = mask.broadcast_like(result)
    return result.assign_coords(mask=Coord(mask.dims, mask.data))


class RankedProbabilityScore(base.PerVariableStatistic):
  """RPS over inputs that already represent CDFs along ``bin_dim``.

  Reference ``categorical.py:307-341``.
  """

  def __init__(self, bin_dim: str):
    self._bin_dim = bin_dim

  @property
  def unique_name(self) -> str:
    return 'RankedProbabilityScore'

  def _compute_per_variable(self, predictions, targets):
    return ((predictions - targets) ** 2).sum(self._bin_dim)


### Metrics over the confusion matrix


class _ConfusionMetric(base.PerVariableMetric):
  _STATS: tuple = ()

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    classes = {'TruePositives': TruePositives,
               'TrueNegatives': TrueNegatives,
               'FalsePositives': FalsePositives,
               'FalseNegatives': FalseNegatives}
    return {name: classes[name]() for name in self._STATS}


class CSI(_ConfusionMetric):
  """Critical Success Index (Threat Score): TP / (TP + FP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (
        s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives'])


class Accuracy(_ConfusionMetric):
  """(TP + TN) / total."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives',
            'TrueNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return (s['TruePositives'] + s['TrueNegatives']) / (
        s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives']
        + s['TrueNegatives'])


class Recall(_ConfusionMetric):
  """TP / (TP + FN)."""

  _STATS = ('TruePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalseNegatives'])


class FalseAlarmRate(_ConfusionMetric):
  """FP / (TP + FP)."""

  _STATS = ('TruePositives', 'FalsePositives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['FalsePositives'] / (s['TruePositives'] + s['FalsePositives'])


class Precision(_ConfusionMetric):
  """TP / (TP + FP)."""

  _STATS = ('TruePositives', 'FalsePositives')

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalsePositives'])


class F1Score(_ConfusionMetric):
  """2TP / (2TP + FP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return 2 * s['TruePositives'] / (
        2 * s['TruePositives'] + s['FalsePositives'] + s['FalseNegatives'])


class FrequencyBias(_ConfusionMetric):
  """(TP + FP) / (TP + FN)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    return (s['TruePositives'] + s['FalsePositives']) / (
        s['TruePositives'] + s['FalseNegatives'])


class HSS(_ConfusionMetric):
  """Heidke Skill Score."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives',
            'TrueNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    return 2 * (tp * tn - fp * fn) / (
        (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


class ETS(_ConfusionMetric):
  """Equitable Threat Score (Gilbert Skill Score)."""

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives',
            'TrueNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    tp_random = ((tp + fp) * (tp + fn)) / (tp + fp + fn + tn)
    return (tp - tp_random) / (tp + fp + fn - tp_random)


class SEDI(_ConfusionMetric):
  """Symmetric extremal dependency index (Ferro & Stephenson 2011).

  Rates clipped to [1e-6, 1-1e-6] (reference ``categorical.py:590-635``).
  """

  _STATS = ('TruePositives', 'FalsePositives', 'FalseNegatives',
            'TrueNegatives')

  def _values_from_mean_statistics_per_variable(self, s):
    tp, tn = s['TruePositives'], s['TrueNegatives']
    fp, fn = s['FalsePositives'], s['FalseNegatives']
    h = (tp / (tp + fn)).clip(1e-6, 1 - 1e-6)
    f = (fp / (fp + tn)).clip(1e-6, 1 - 1e-6)
    log_h, log_f = darray.log(h), darray.log(f)
    log_1mh, log_1mf = darray.log(1 - h), darray.log(1 - f)
    return (log_f - log_h + log_1mh - log_1mf) / (
        log_h + log_f + log_1mh + log_1mf)


class Reliability(base.PerVariableMetric):
  """Calibration curve over binned predicted probabilities.

  Reference ``categorical.py:638-698``.
  """

  def __init__(
      self,
      bin_values: Sequence[float] = (
          -np.inf, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
      bin_dim: str = 'reliability_bin',
      statistic_suffix: str | None = None,
  ):
    self._bin_values = bin_values
    self._bin_dim = bin_dim
    self._unique_name_suffix = statistic_suffix

  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    binned = wrappers.ContinuousToBins(
        which='predictions', bin_values=self._bin_values,
        bin_dim=self._bin_dim, unique_name_suffix=self._unique_name_suffix)
    return {
        'TruePositives': wrappers.WrappedStatistic(TruePositives(), binned),
        'FalsePositives': wrappers.WrappedStatistic(FalsePositives(), binned),
    }

  def _values_from_mean_statistics_per_variable(self, s):
    return s['TruePositives'] / (s['TruePositives'] + s['FalsePositives'])


### Decision-support statistics (Confident/Covered/JaccardDistant/Opportunism)


class Confident(base.PerVariableStatisticWithClimatology):
  """prediction spread < threshold × climatological spread.

  Climatology variables hold quantiles along a 'quantile' dim
  (reference ``categorical.py:701-747``).
  """

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               spread_quantile_boundaries: tuple = (0.1, 0.9),
               confidence_threshold: float = 0.7):
    super().__init__(climatology)
    self._ensemble_dim = ensemble_dim
    self._spread_low, self._spread_high = spread_quantile_boundaries
    self._confidence_threshold = confidence_threshold

  @property
  def unique_name(self) -> str:
    return ('Confident'
            + f'_conf_thres={self._confidence_threshold}'
            + f'_spread_low={self._spread_low}'
            + f'_spread_high={self._spread_high}')

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    del targets
    spread = (predictions.quantile(self._spread_high, self._ensemble_dim)
              - predictions.quantile(self._spread_low, self._ensemble_dim)
              ).isel(quantile=0)
    clim_spread = (aligned_climatology.sel(quantile=self._spread_high)
                   - aligned_climatology.sel(quantile=self._spread_low))
    return spread < self._confidence_threshold * clim_spread


class Covered(base.PerVariableStatistic):
  """Target inside the [low, high] ensemble quantile interval."""

  def __init__(self, ensemble_dim: str,
               interval_quantile_boundaries: tuple = (0.1, 0.9)):
    self._ensemble_dim = ensemble_dim
    self._interval_low, self._interval_high = interval_quantile_boundaries

  @property
  def unique_name(self) -> str:
    return ('Covered'
            + f'_interval_low={self._interval_low}'
            + f'_interval_high={self._interval_high}')

  def _compute_per_variable(self, predictions, targets):
    lo = predictions.quantile(self._interval_low, self._ensemble_dim
                              ).isel(quantile=0)
    hi = predictions.quantile(self._interval_high, self._ensemble_dim
                              ).isel(quantile=0)
    return (lo <= targets) & (targets <= hi)


class JaccardDistant(base.PerVariableStatisticWithClimatology):
  """Jaccard distance of prediction vs climatology interval > threshold.

  Reference ``categorical.py:788-863``.
  """

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               threshold: float = 0.75,
               interval_quantile_boundaries: tuple = (0.1, 0.9)):
    super().__init__(climatology)
    self._ensemble_dim = ensemble_dim
    self._threshold = threshold
    self._interval_low, self._interval_high = interval_quantile_boundaries

  @property
  def unique_name(self) -> str:
    return ('JaccardDistant'
            + f'_threshold={self._threshold}'
            + f'_interval_low={self._interval_low}'
            + f'_interval_high={self._interval_high}')

  def _compute_per_variable_with_aligned_climatology(
      self, predictions, targets, aligned_climatology):
    del targets
    pred_lo = predictions.quantile(self._interval_low, self._ensemble_dim
                                   ).isel(quantile=0)
    pred_hi = predictions.quantile(self._interval_high, self._ensemble_dim
                                   ).isel(quantile=0)
    clim_lo = aligned_climatology.sel(quantile=self._interval_low)
    clim_hi = aligned_climatology.sel(quantile=self._interval_high)
    max_of_lows = darray.maximum(pred_lo, clim_lo)
    min_of_highs = darray.minimum(pred_hi, clim_hi)
    intersection = darray.maximum(min_of_highs - max_of_lows, 0.0)
    union = (pred_hi - pred_lo) + (clim_hi - clim_lo) - intersection
    jaccard_index = darray.where(union > 0, intersection / union, 1.0)
    return (1 - jaccard_index) > self._threshold


class Opportunism(base.PerVariableMetric):
  """Fraction of forecasts (un)confident × (un)covered × (un)distant.

  Reference ``categorical.py:866-971``.
  """

  def __init__(self, ensemble_dim: str,
               climatology: Mapping[Hashable, DimArray],
               is_confident: bool,
               is_covered: bool | None = None,
               is_jaccard_distant: bool | None = None,
               confidence_quantile_boundaries: tuple = (0.1, 0.9),
               coverage_quantile_boundaries: tuple = (0.1, 0.9),
               jaccard_distance_quantile_boundaries: tuple = (0.1, 0.9),
               confidence_threshold: float = 0.7,
               jaccard_distance_threshold: float = 0.75):
    self._is_confident = is_confident
    self._is_covered = is_covered
    self._is_jaccard_distant = is_jaccard_distant
    self._ensemble_dim = ensemble_dim
    self._climatology = climatology
    self._confidence_quantile_boundaries = confidence_quantile_boundaries
    self._coverage_quantile_boundaries = coverage_quantile_boundaries
    self._jaccard_distance_quantile_boundaries = (
        jaccard_distance_quantile_boundaries)
    self._confidence_threshold = confidence_threshold
    self._jaccard_distance_threshold = jaccard_distance_threshold

  @final
  @property
  def statistics(self) -> Mapping[str, base.Statistic]:
    statistics: dict[str, base.Statistic] = {
        'Confident': Confident(
            ensemble_dim=self._ensemble_dim,
            climatology=self._climatology,
            spread_quantile_boundaries=self._confidence_quantile_boundaries,
            confidence_threshold=self._confidence_threshold),
    }
    if self._is_covered is not None:
      statistics['Covered'] = Covered(
          ensemble_dim=self._ensemble_dim,
          interval_quantile_boundaries=self._coverage_quantile_boundaries)
    if self._is_jaccard_distant is not None:
      statistics['JaccardDistant'] = JaccardDistant(
          ensemble_dim=self._ensemble_dim,
          climatology=self._climatology,
          threshold=self._jaccard_distance_threshold,
          interval_quantile_boundaries=(
              self._jaccard_distance_quantile_boundaries))
    return statistics

  def _values_from_mean_statistics_per_variable(self, s):
    confident = s['Confident']
    values = confident if self._is_confident else 1 - confident
    if self._is_covered is not None:
      covered = s['Covered']
      values = values * (covered if self._is_covered else 1 - covered)
    if self._is_jaccard_distant is not None:
      jd = s['JaccardDistant']
      values = values * (jd if self._is_jaccard_distant else 1 - jd)
    return values
