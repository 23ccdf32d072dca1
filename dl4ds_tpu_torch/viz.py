"""Interactive + georeferenced visualization (ecubevis counterpart): the
port's copy of the JAX package's `viz.py` (dl4ds_tpu/viz.py).

The reference renders its debug panels and metric maps through `ecubevis`
(ref: dl4ds/dataloader.py:5 + 260-289, dl4ds/metrics.py:10 + 202-218),
which adds two things over plain matplotlib: interactive exploration
(sliders over the time axis, hover readout) and georeferenced projected
maps. This module provides both with ZERO extra dependencies:

  * `interactive_panel` writes a fully self-contained HTML file — the
    array is embedded (quantized uint16 + min/max, base64), rendered to a
    <canvas> by inline JS with a viridis colormap, a time slider for
    [T, H, W] stacks, a variable selector for [T, H, W, C], and a mouse
    hover readout showing the value (and lat/lon when given). Open it in
    any browser; nothing is fetched from the network. Its bytes equal the
    JAX package's for the same array.
  * `plot_projected` draws lat/lon-referenced fields on a geographic
    projection using matplotlib's built-in geographic axes
    ('mollweide' | 'hammer' | 'aitoff' | 'lambert'), or on a cartopy CRS
    with coastlines where cartopy is installed.

Both take numpy arrays (or anything `np.asarray` reads, a CPU tensor
included); matplotlib is imported inside `plot_projected` alone. They are
reached from `utils.plot_ndarray(interactive=True)` and the `projection=`
of `compute_metrics` and `compute_prob_metrics`.
"""

import base64
import json
import os

import numpy as np

__all__ = ['interactive_panel', 'plot_projected']


# 32-stop viridis, embedded so the HTML needs no matplotlib at view time
_VIRIDIS = [
    (68, 1, 84), (71, 13, 96), (72, 24, 106), (72, 35, 116),
    (71, 45, 123), (69, 55, 129), (66, 64, 134), (62, 73, 137),
    (58, 82, 139), (54, 90, 140), (50, 98, 141), (46, 106, 142),
    (43, 114, 142), (40, 121, 142), (37, 129, 142), (34, 136, 141),
    (31, 144, 140), (29, 151, 138), (29, 159, 136), (32, 166, 133),
    (40, 174, 127), (52, 181, 121), (67, 188, 112), (84, 194, 102),
    (103, 199, 90), (124, 204, 76), (146, 208, 60), (169, 211, 43),
    (192, 213, 28), (215, 213, 24), (237, 211, 35), (253, 231, 37)]

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 16px; }}
 #wrap {{ display: inline-block; position: relative; }}
 canvas {{ image-rendering: pixelated; border: 1px solid #999; }}
 #readout {{ font: 13px monospace; margin-top: 6px; min-height: 1.2em; }}
 #bar {{ margin: 8px 0; }}
 input[type=range] {{ width: 320px; vertical-align: middle; }}
</style></head><body>
<h3>{title}</h3>
<div id="bar">
 <label>t <input id="tslider" type="range" min="0" max="{tmax}" value="0">
 <span id="tlabel">0</span></label>
 <label style="margin-left:16px">channel
  <select id="csel">{copts}</select></label>
 <span style="margin-left:16px">min {vmin:.4g} &mdash; max {vmax:.4g}</span>
</div>
<div id="wrap"><canvas id="cv" width="{w}" height="{h}"
 style="width:{dw}px;height:{dh}px"></canvas></div>
<div id="readout">hover for values</div>
<script>
const T={t}, H={h}, W={w}, C={c}, VMIN={vmin}, VMAX={vmax};
const LATS={lats}, LONS={lons};
const PAL={palette};
const raw = Uint8Array.from(atob("{b64}"), ch => ch.charCodeAt(0));
const data = new Uint16Array(raw.buffer);   // [T,H,W,C] row-major
function val(t,y,x,c) {{
  const q = data[((t*H + y)*W + x)*C + c];
  return VMIN + (q/65535)*(VMAX-VMIN);
}}
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const img = ctx.createImageData(W, H);
let ct = 0, cc = 0;
function colour(v) {{
  let u = (v - VMIN)/(VMAX - VMIN); u = Math.min(1, Math.max(0, u));
  const k = u*(PAL.length-1), i = Math.floor(k), f = k-i;
  const a = PAL[i], b = PAL[Math.min(i+1, PAL.length-1)];
  return [a[0]+(b[0]-a[0])*f, a[1]+(b[1]-a[1])*f, a[2]+(b[2]-a[2])*f];
}}
function draw() {{
  for (let y=0; y<H; y++) for (let x=0; x<W; x++) {{
    const rgb = colour(val(ct, y, x, cc)), o = (y*W + x)*4;
    img.data[o]=rgb[0]; img.data[o+1]=rgb[1]; img.data[o+2]=rgb[2];
    img.data[o+3]=255;
  }}
  ctx.putImageData(img, 0, 0);
}}
document.getElementById('tslider').oninput = e => {{
  ct = +e.target.value;
  document.getElementById('tlabel').textContent = ct; draw();
}};
document.getElementById('csel').onchange = e => {{
  cc = +e.target.value; draw();
}};
cv.onmousemove = e => {{
  const r = cv.getBoundingClientRect();
  const x = Math.min(W-1, Math.floor((e.clientX-r.left)/r.width*W));
  const y = Math.min(H-1, Math.floor((e.clientY-r.top)/r.height*H));
  let geo = '';
  if (LATS && LONS) geo = `  lat ${{LATS[y].toFixed(3)}} lon ` +
                          `${{LONS[x].toFixed(3)}}`;
  document.getElementById('readout').textContent =
    `t=${{ct}} y=${{y}} x=${{x}}${{geo}}  value=` +
    val(ct, y, x, cc).toFixed(6);
}};
draw();
</script></body></html>
"""


def interactive_panel(array, lats=None, lons=None, save_path='panel.html',
                      title='dl4ds_tpu interactive panel', max_display=640):
    """Write a self-contained interactive HTML viewer for a field stack.

    `array`: [H, W], [T, H, W] or [T, H, W, C]. `lats`/`lons`: optional 1-D
    coordinate vectors (georeferenced hover readout). Values are quantized
    to uint16 over [min, max] (range recorded exactly — display error
    <= range/65535). Returns the saved path.
    """
    a = np.asarray(array, 'float32')
    if a.ndim == 2:
        a = a[None, ..., None]
    elif a.ndim == 3:
        a = a[..., None]
    if a.ndim != 4:
        raise ValueError('`array` must be [H,W], [T,H,W] or [T,H,W,C], got '
                         f'shape {np.shape(array)}')
    t, h, w, c = a.shape
    finite = np.isfinite(a)
    if not finite.any():
        raise ValueError('`array` has no finite values')
    vmin = float(a[finite].min())
    vmax = float(a[finite].max())
    span = (vmax - vmin) or 1.0
    q = np.clip((np.nan_to_num(a, nan=vmin) - vmin) / span, 0, 1)
    q16 = (q * 65535).astype('<u2')
    if lats is not None and len(np.asarray(lats)) != h:
        raise ValueError(f'`lats` must have length H={h}')
    if lons is not None and len(np.asarray(lons)) != w:
        raise ValueError(f'`lons` must have length W={w}')
    disp = max(1.0, max_display / max(h, w))
    html = _HTML_TEMPLATE.format(
        title=title, t=t, h=h, w=w, c=c, tmax=t - 1,
        dw=int(w * disp), dh=int(h * disp),
        vmin=vmin, vmax=vmax,
        copts=''.join(f'<option value="{i}">{i}</option>' for i in range(c)),
        lats=(json.dumps([round(float(v), 6) for v in np.asarray(lats)])
              if lats is not None else 'null'),
        lons=(json.dumps([round(float(v), 6) for v in np.asarray(lons)])
              if lons is not None else 'null'),
        palette=json.dumps(_VIRIDIS),
        b64=base64.b64encode(q16.tobytes()).decode('ascii'))
    save_path = os.path.abspath(save_path)
    with open(save_path, 'w') as fh:
        fh.write(html)
    return save_path


def _cartopy_projection(name):
    """cartopy CRS for `name`, or None when cartopy is absent / the name
    is unknown to it (caller falls back to matplotlib's geo axes)."""
    try:
        import cartopy.crs as ccrs
    except ImportError:
        return None
    table = {'mollweide': ccrs.Mollweide, 'robinson': ccrs.Robinson,
             'platecarree': ccrs.PlateCarree, 'mercator': ccrs.Mercator,
             'orthographic': ccrs.Orthographic,
             'lambert': ccrs.LambertCylindrical,
             'hammer': getattr(ccrs, 'Hammer', None),
             'aitoff': getattr(ccrs, 'Aitoff', None)}
    cls = table.get(str(name).lower())
    return cls() if cls is not None else None


def plot_projected(array, lats, lons, projection='mollweide', cmap='viridis',
                   plot_title=None, save_fname=None, dpi=100):
    """Georeferenced field on a true geographic projection — the
    projected-map role ecubevis fills in the reference's metric maps
    (ref metrics.py:202-218).

    With cartopy installed, `projection` resolves to a cartopy CRS
    ('mollweide' | 'robinson' | 'platecarree' | 'mercator' |
    'orthographic' | 'lambert' | ...) and panels get coastlines —
    matching the reference's ecubevis output class. Without cartopy (it
    is optional), matplotlib's built-in geographic axes ('mollweide' |
    'hammer' | 'aitoff' | 'lambert') are used; unknown names fall back
    to 'mollweide' with a warning, never an ImportError.

    `array`: [H, W] (or [N, H, W]: panels). `lats` [H] / `lons` [W] in
    degrees; lons may be 0..360 (wrapped to -180..180 internally).
    """
    import matplotlib
    if save_fname is not None:
        matplotlib.use('Agg', force=False)
    import matplotlib.pyplot as plt

    a = np.asarray(array, 'float32')
    if a.ndim == 2:
        a = a[None]
    if a.ndim != 3:
        raise ValueError('`array` must be [H,W] or [N,H,W]')
    lats = np.asarray(lats, 'float64')
    lons = np.asarray(lons, 'float64')
    if lats.shape != (a.shape[1],) or lons.shape != (a.shape[2],):
        raise ValueError('lats/lons must match the field dims '
                         f'H={a.shape[1]}, W={a.shape[2]}')
    lons = np.where(lons > 180.0, lons - 360.0, lons)
    order = np.argsort(lons)
    lons = lons[order]
    a = a[:, :, order]
    n = a.shape[0]
    crs = _cartopy_projection(projection)
    fig = plt.figure(figsize=(6 * n, 3.2), dpi=dpi)
    if crs is not None:
        import cartopy.crs as ccrs
        for i in range(n):
            ax = fig.add_subplot(1, n, i + 1, projection=crs)
            mesh = ax.pcolormesh(lons, lats, a[i], cmap=cmap,
                                 shading='auto',
                                 transform=ccrs.PlateCarree())
            ax.coastlines(linewidth=0.5)
            ax.gridlines(alpha=0.3)
            fig.colorbar(mesh, ax=ax, shrink=0.7)
    else:
        mpl_geo = ('mollweide', 'hammer', 'aitoff', 'lambert')
        proj = str(projection).lower()
        if proj not in mpl_geo:
            import warnings
            warnings.warn(
                f'projection {projection!r} needs cartopy (not installed) '
                f"— falling back to matplotlib 'mollweide'", RuntimeWarning)
            proj = 'mollweide'
        lon_r = np.deg2rad(lons)
        lat_r = np.deg2rad(lats)
        for i in range(n):
            ax = fig.add_subplot(1, n, i + 1, projection=proj)
            mesh = ax.pcolormesh(lon_r, lat_r, a[i], cmap=cmap,
                                 shading='auto')
            ax.grid(True, alpha=0.3)
            fig.colorbar(mesh, ax=ax, shrink=0.7)
    if plot_title:
        fig.suptitle(plot_title)
    if save_fname is not None:
        fig.savefig(save_fname, bbox_inches='tight')
        plt.close(fig)
        return save_fname
    return fig
