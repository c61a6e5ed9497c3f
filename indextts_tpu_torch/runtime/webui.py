"""Browser demo UI (reference: webui.py, Gradio-based).

Copy of indextts_tpu/runtime/webui.py for the PyTorch port.

Gradio is not a dependency of this framework; the UI is a single
self-contained HTML page served by our own HTTP server at GET /ui, covering
the reference demo's controls: text, speaker prompt path, 4 emotion-control
modes (none / reference audio / 8-dim vector sliders / text), emo alpha, and
advanced sampling params.
"""

def render_ui(lang=None) -> str:
    """Localized UI page (parity: tools/i18n applied to webui.py labels).

    Only text enclosed by tags (`>label<`) is substituted, so element ids and
    JS identifiers can never be mangled by a translation."""
    from indextts_tpu_torch.utils.i18n import LOCALES, I18nAuto

    i18n = I18nAuto(lang)
    html = UI_HTML
    keys = set()
    for m in LOCALES.values():
        keys.update(m)
    for key in sorted(keys, key=len, reverse=True):
        html = html.replace(f">{key}<", f">{i18n(key)}<")
    return html


UI_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>IndexTTS-TPU</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 720px;
        background: #111; color: #eee; }
 h1 { font-size: 1.3rem; } fieldset { border: 1px solid #444; margin: .8rem 0; }
 label { display: block; margin: .4rem 0 .1rem; font-size: .85rem; color: #aaa; }
 textarea, input, select { width: 100%; box-sizing: border-box; background: #1c1c1c;
        color: #eee; border: 1px solid #555; padding: .4rem; }
 .row { display: flex; gap: .6rem; } .row > div { flex: 1; }
 button { background: #2a6; color: #fff; border: 0; padding: .6rem 1.4rem;
        margin-top: 1rem; cursor: pointer; font-size: 1rem; }
 #status { margin-top: .6rem; color: #8cf; min-height: 1.2em; }
 .emo-sliders { display: none; } .emo-sliders.on { display: block; }
</style>
</head>
<body>
<h1>IndexTTS‑TPU — zero-shot TTS</h1>
<fieldset><legend>Input</legend>
 <label>Text</label>
 <textarea id="text" rows="3">Hello! This is IndexTTS2 on PyTorch.</textarea>
 <label>Speaker prompt (server-side wav path; empty = server default)</label>
 <input id="spk" placeholder="examples/voice_01.wav"/>
</fieldset>
<fieldset><legend>Emotion control</legend>
 <select id="emo_mode">
  <option value="0">Same as speaker</option>
  <option value="1">Reference audio</option>
  <option value="2">Emotion vector</option>
  <option value="3">From text</option>
 </select>
 <div id="emo_audio_row" style="display:none">
  <label>Emotion reference wav path</label><input id="emo_audio"/>
  <label>Alpha</label><input id="emo_alpha" type="number" step="0.05" value="1.0"/>
 </div>
 <div id="emo_vec_row" class="emo-sliders">
  <div class="row" id="sliders"></div>
 </div>
</fieldset>
<fieldset><legend>Sampling</legend>
 <div class="row">
  <div><label>temperature</label><input id="temperature" type="number" step="0.05" value="0.8"/></div>
  <div><label>top_p</label><input id="top_p" type="number" step="0.05" value="0.8"/></div>
  <div><label>seed</label><input id="seed" type="number" value=""/></div>
 </div>
</fieldset>
<button onclick="synth()">Synthesize</button>
<div id="status"></div>
<audio id="player" controls style="width:100%;margin-top:1rem"></audio>
<script>
const EMOS = ["happy","angry","sad","afraid","disgusted","melancholic","surprised","calm"];
const sliders = document.getElementById("sliders");
EMOS.forEach(e => {
  const d = document.createElement("div");
  d.innerHTML = `<label>${e}</label><input type="range" id="emo_${e}" min="0" max="1" step="0.05" value="0"/>`;
  sliders.appendChild(d);
});
document.getElementById("emo_mode").onchange = ev => {
  document.getElementById("emo_audio_row").style.display = ev.target.value=="1"?"block":"none";
  document.getElementById("emo_vec_row").className = ev.target.value=="2"?"emo-sliders on":"emo-sliders";
};
async function synth() {
  const mode = document.getElementById("emo_mode").value;
  const body = { text: document.getElementById("text").value };
  const spk = document.getElementById("spk").value; if (spk) body.spk_audio = spk;
  if (mode == "1") {
    body.emo_audio = document.getElementById("emo_audio").value;
    body.emo_alpha = parseFloat(document.getElementById("emo_alpha").value);
  } else if (mode == "2") {
    body.emo_vector = EMOS.map(e => parseFloat(document.getElementById("emo_"+e).value));
  } else if (mode == "3") {
    body.use_emo_text = true;
  }
  const seed = document.getElementById("seed").value;
  if (seed !== "") body.seed = parseInt(seed);
  const st = document.getElementById("status");
  st.textContent = "synthesizing…"; const t0 = performance.now();
  const r = await fetch("/tts", { method: "POST",
      headers: {"Content-Type": "application/json"}, body: JSON.stringify(body)});
  if (!r.ok) { st.textContent = "error: " + await r.text(); return; }
  const blob = await r.blob();
  document.getElementById("player").src = URL.createObjectURL(blob);
  st.textContent = `done in ${((performance.now()-t0)/1000).toFixed(2)}s`;
}
</script>
</body>
</html>"""
