"""Built-in browser demo page (GET /), a copy of
``supertonic_tpu.serve.demo_page``: one dependency-free HTML page over the
HTTP API. Voices come from GET /voices; audio from POST /tts (or
/tts/stream for long-form, played progressively via Web Audio as PCM chunks
arrive, with time-to-first-audio shown live). Synthesis runs on the server.
"""

DEMO_HTML = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>supertonic-tpu demo</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 15px/1.5 system-ui, sans-serif; max-width: 680px;
         margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.3rem; }
  textarea { width: 100%; min-height: 6rem; font: inherit; }
  .row { display: flex; gap: 1rem; flex-wrap: wrap; margin: .8rem 0;
         align-items: end; }
  label { display: flex; flex-direction: column; font-size: .85rem; gap: .2rem; }
  button { font: inherit; padding: .45rem 1.2rem; cursor: pointer; }
  #status { margin: .6rem 0; min-height: 1.3rem; font-size: .9rem; opacity: .85; }
  audio { width: 100%; margin-top: .6rem; }
  a#dl { font-size: .85rem; }
</style></head><body>
<h1>supertonic-tpu &mdash; text to speech</h1>
<textarea id="text">This morning, I took a walk in the park, and the sound of the birds and the breeze felt so pleasant that I stopped to listen a while longer.</textarea>
<div class="row">
  <label>Voice <select id="voice"></select></label>
  <label>Language <select id="lang">
    <option>en</option><option>ko</option><option>es</option>
    <option>pt</option><option>fr</option></select></label>
  <label>Steps <input id="steps" type="number" value="5" min="1" max="50" style="width:4.5rem"></label>
  <label>Speed <input id="speed" type="number" value="1.05" min="0.5" max="2" step="0.05" style="width:4.5rem"></label>
  <label><input id="stream" type="checkbox"> stream</label>
  <button id="go">Generate</button>
</div>
<div id="status"></div>
<audio id="player" controls></audio>
<a id="dl" hidden download="tts.wav">download WAV</a>
<script>
const $ = (id) => document.getElementById(id);
fetch('/voices').then(r => r.json()).then(v => {
  for (const name of v.voices) {
    const o = document.createElement('option'); o.textContent = name;
    $('voice').appendChild(o);
  }
});
// JSON content type is required by the FastAPI twin (serve/app.py serves
// this same page); fetch defaults to text/plain and Pydantic would 422
const JSON_HDRS = {'Content-Type': 'application/json'};
$('go').onclick = async () => {
  const body = JSON.stringify({
    text: $('text').value, lang: $('lang').value,
    voice_style: $('voice').value, total_step: +$('steps').value,
    speed: +$('speed').value });
  $('go').disabled = true; $('dl').hidden = true;
  const t0 = performance.now();
  try {
    if ($('stream').checked) {
      $('status').textContent = 'streaming…';
      const r = await fetch('/tts/stream',
                            {method: 'POST', headers: JSON_HDRS, body});
      if (!r.ok) throw new Error((await r.json()).detail || r.status);
      await streamPlay(r, t0);  // progressive Web Audio playback
    } else {
      $('status').textContent = 'synthesizing…';
      const r = await fetch('/tts', {method: 'POST', headers: JSON_HDRS, body});
      if (!r.ok) throw new Error((await r.json()).detail || r.status);
      finish(await r.blob(), t0);
    }
  } catch (e) { $('status').textContent = 'error: ' + e.message; }
  $('go').disabled = false;
};
// Progressive playback of the chunked WAV: PCM16 pieces are scheduled as
// sequential Web Audio buffers the moment they arrive, so playback starts
// at the server's time-to-first-audio instead of after the full response
// (await r.blob() would buffer everything — the anti-pattern this replaces).
async function streamPlay(r, t0) {
  const reader = r.body.getReader();
  const actx = new (window.AudioContext || window.webkitAudioContext)();
  let head = new Uint8Array(0), sr = 44100, headerDone = false;
  let playT = 0, ttfa = null, total = 0;
  const parts = [];
  let carry = new Uint8Array(0);
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    parts.push(value);
    let buf = value;
    if (!headerDone) {
      const h = new Uint8Array(head.length + buf.length);
      h.set(head); h.set(buf, head.length); head = h;
      if (head.length < 44) continue;       // RIFF + fmt + data prelude
      // validate the canonical header before decoding: silently playing
      // noise if the server writer ever changes layout would be worse
      // than a visible error
      const dv = new DataView(head.buffer);
      const tag = (o) => String.fromCharCode(head[o], head[o+1], head[o+2], head[o+3]);
      if (tag(0) !== 'RIFF' || tag(8) !== 'WAVE') {
        $('status').textContent = 'stream error: not a WAV response';
        return;
      }
      // walk chunks to the 'data' chunk (fmt may grow extension bytes)
      let off = 12, fmtOk = false, dataOff = -1;
      while (off + 8 <= head.length) {
        const id = tag(off), sz = dv.getUint32(off + 4, true);
        if (id === 'fmt ') {
          fmtOk = dv.getUint16(off + 8, true) === 1 &&       // PCM
                  dv.getUint16(off + 10, true) === 1 &&      // mono
                  dv.getUint16(off + 22, true) === 16;       // 16-bit
          sr = dv.getUint32(off + 12, true);
        } else if (id === 'data') { dataOff = off + 8; break; }
        off += 8 + sz + (sz & 1);
      }
      if (dataOff < 0) continue;            // data chunk not seen yet
      if (!fmtOk) {
        $('status').textContent = 'stream error: unsupported WAV format';
        return;
      }
      buf = head.subarray(dataOff); headerDone = true;
    }
    if (carry.length) {
      const b2 = new Uint8Array(carry.length + buf.length);
      b2.set(carry); b2.set(buf, carry.length); buf = b2;
    }
    const n = buf.length >> 1;              // whole PCM16 samples
    carry = buf.slice(n * 2);               // odd trailing byte, if any
    if (!n) continue;
    const i16 = new Int16Array(buf.slice(0, n * 2).buffer);
    const ab = actx.createBuffer(1, n, sr);
    ab.copyToChannel(Float32Array.from(i16, x => x / 32768), 0);
    const src = actx.createBufferSource();
    src.buffer = ab; src.connect(actx.destination);
    const at = Math.max(actx.currentTime + 0.03, playT);
    src.start(at); playT = at + ab.duration; total += n;
    if (ttfa === null) {
      ttfa = (performance.now() - t0) / 1000;
      $('status').textContent =
        `first audio in ${(ttfa * 1000).toFixed(0)} ms — streaming…`;
    }
  }
  const secs = (performance.now() - t0) / 1000;
  const audioSecs = total / sr;
  const blob = new Blob(parts, {type: 'audio/wav'});
  const url = URL.createObjectURL(blob);
  $('player').src = url;                    // replayable copy + download
  $('dl').href = url; $('dl').hidden = false;
  $('status').textContent =
    `streamed ${audioSecs.toFixed(2)}s: first audio ` +
    `${((ttfa || 0) * 1000).toFixed(0)} ms, full stream ${secs.toFixed(2)}s` +
    ` · RTF ${(secs / audioSecs).toFixed(3)}`;
}
function finish(blob, t0) {
  const secs = (performance.now() - t0) / 1000;
  const url = URL.createObjectURL(blob);
  $('player').src = url; $('player').play();
  $('dl').href = url; $('dl').hidden = false;
  // audio duration for the RTF readout (reference iOS app shows the same,
  // ios/README.md:53)
  $('player').onloadedmetadata = () => {
    const rtf = secs / $('player').duration;
    $('status').textContent =
      `synthesized ${$('player').duration.toFixed(2)}s in ${secs.toFixed(2)}s` +
      ` · RTF ${rtf.toFixed(3)}`;
  };
}
</script></body></html>
"""
