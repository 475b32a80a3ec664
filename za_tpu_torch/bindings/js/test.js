// The p*q=r round trip of every binding's smoke test, in a directory of
// its own: node test.js [engine] (gpu, the default: the card; host).
const za2 = require('./index.js');
const fs = require('fs');
const os = require('os');
const path = require('path');

const work = fs.mkdtempSync(path.join(os.tmpdir(), 'za2js_'));
const circuit = path.join(work, 'circuit.za');
const pk = path.join(work, 'proving.key');
fs.writeFileSync(circuit, `
template Factor() {
  signal private input p;
  signal private input q;
  signal input r;
  p * q === r;
}
component main = Factor();
`);

za2.verbose(false);
za2.engine(process.argv[2] || 'gpu');
let refused = false;
try { za2.engine('tpu'); } catch (e) { refused = true; }
if (!refused) throw new Error('engine("tpu") accepted');
const verifier = za2.setupSync(circuit, pk, 'json');
const proof = za2.proveSync(pk, '{"p":"2","q":"3","r":"6"}');
if (!za2.verifySync(verifier, proof)) throw new Error('verify failed');
const bad = proof.replace('"6"', '"7"');
if (za2.verifySync(verifier, bad)) throw new Error('tampered proof accepted');
fs.rmSync(work, { recursive: true });
console.log('ALL JS BINDING TESTS PASS');
