"""Solidity verifier contract generator.

Emits the standard EVM Groth16 verifier (ecAdd 0x6 / ecMul 0x7 /
pairing 0x8 precompiles; final check
pairingProd4(A*B, -vk_x*gamma, -C*delta, -alpha*beta)), equivalent in
behavior to the reference generator (prover/src/groth16/ethereum.rs).
G2 coordinates are emitted imaginary-part-first (c1 before c0), both in
the embedded key and in verifyTx input packing (ethereum.rs:227-238,200).
"""

from __future__ import annotations

from ..curve import Q
from .setup import VerifyingKey

_TEMPLATE = """\
pragma solidity ^0.5.0;

library Pairing {
    struct G1Point {
        uint X;
        uint Y;
    }
    // Encoding of Fq2 elements is: X[0] * z + X[1]
    struct G2Point {
        uint[2] X;
        uint[2] Y;
    }

    function P1() internal pure returns (G1Point memory) {
        return G1Point(1, 2);
    }

    function negate(G1Point memory p) internal pure returns (G1Point memory) {
        uint q = <%fq_modulus%>;
        if (p.X == 0 && p.Y == 0)
            return G1Point(0, 0);
        return G1Point(p.X, q - (p.Y % q));
    }

    function addition(G1Point memory p1, G1Point memory p2) internal view returns (G1Point memory r) {
        uint[4] memory input;
        input[0] = p1.X;
        input[1] = p1.Y;
        input[2] = p2.X;
        input[3] = p2.Y;
        bool success;
        // solium-disable-next-line security/no-inline-assembly
        assembly {
            success := staticcall(sub(gas, 2000), 6, input, 0xc0, r, 0x60)
            switch success case 0 { invalid() }
        }
        require(success, "pairing-add-failed");
    }

    function scalar_mul(G1Point memory p, uint s) internal view returns (G1Point memory r) {
        uint[3] memory input;
        input[0] = p.X;
        input[1] = p.Y;
        input[2] = s;
        bool success;
        // solium-disable-next-line security/no-inline-assembly
        assembly {
            success := staticcall(sub(gas, 2000), 7, input, 0x80, r, 0x60)
            switch success case 0 { invalid() }
        }
        require(success, "pairing-mul-failed");
    }

    function pairing(G1Point[] memory p1, G2Point[] memory p2) internal view returns (bool) {
        require(p1.length == p2.length, "pairing-lengths-failed");
        uint elements = p1.length;
        uint inputSize = elements * 6;
        uint[] memory input = new uint[](inputSize);
        for (uint i = 0; i < elements; i++) {
            input[i * 6 + 0] = p1[i].X;
            input[i * 6 + 1] = p1[i].Y;
            input[i * 6 + 2] = p2[i].X[0];
            input[i * 6 + 3] = p2[i].X[1];
            input[i * 6 + 4] = p2[i].Y[0];
            input[i * 6 + 5] = p2[i].Y[1];
        }
        uint[1] memory out;
        bool success;
        // solium-disable-next-line security/no-inline-assembly
        assembly {
            success := staticcall(sub(gas, 2000), 8, add(input, 0x20), mul(inputSize, 0x20), out, 0x20)
            switch success case 0 { invalid() }
        }
        require(success, "pairing-opcode-failed");
        return out[0] != 0;
    }

    function pairingProd4(
            G1Point memory a1, G2Point memory a2,
            G1Point memory b1, G2Point memory b2,
            G1Point memory c1, G2Point memory c2,
            G1Point memory d1, G2Point memory d2
    ) internal view returns (bool) {
        G1Point[] memory p1 = new G1Point[](4);
        G2Point[] memory p2 = new G2Point[](4);
        p1[0] = a1;
        p1[1] = b1;
        p1[2] = c1;
        p1[3] = d1;
        p2[0] = a2;
        p2[1] = b2;
        p2[2] = c2;
        p2[3] = d2;
        return pairing(p1, p2);
    }
}

contract Verifier {
    using Pairing for *;

    struct VerifyingKey {
        Pairing.G1Point a;
        Pairing.G2Point b;
        Pairing.G2Point gamma;
        Pairing.G2Point delta;
        Pairing.G1Point[] gammaABC;
    }

    struct Proof {
        Pairing.G1Point A;
        Pairing.G2Point B;
        Pairing.G1Point C;
    }

    function verifyingKey() pure internal returns (VerifyingKey memory vk) {
        vk.a = Pairing.G1Point(<%vk_a%>);
        vk.b = Pairing.G2Point(<%vk_b%>);
        vk.gamma = Pairing.G2Point(<%vk_gamma%>);
        vk.delta = Pairing.G2Point(<%vk_delta%>);
        vk.gammaABC = new Pairing.G1Point[](<%vk_gammaABC_length%>);
        <%vk_gammaABC_pts%>
    }

    function verify(uint[] memory input, Proof memory proof) internal returns (uint) {
        uint256 snark_scalar_field = <%fr_modulus%>;
        VerifyingKey memory vk = verifyingKey();
        require(input.length + 1 == vk.gammaABC.length);
        // Compute the linear combination vk_x
        Pairing.G1Point memory vk_x = Pairing.G1Point(0, 0);
        for (uint i = 0; i < input.length; i++) {
            require(input[i] < snark_scalar_field, "err-input-not-in-field");
            vk_x = Pairing.addition(vk_x, Pairing.scalar_mul(vk.gammaABC[i + 1], input[i]));
        }
        vk_x = Pairing.addition(vk_x, vk.gammaABC[0]);
        if (!Pairing.pairingProd4(
             proof.A, proof.B,
             Pairing.negate(vk_x), vk.gamma,
             Pairing.negate(proof.C), vk.delta,
             Pairing.negate(vk.a), vk.b)) return 1;
        return 0;
    }

    event Verified(string s);

    // input = <%vk_inputs%>
    function verifyTx(
            uint[2] memory a,
            uint[2][2] memory b,
            uint[2] memory c,
            uint[<%vk_inputs_length%>] memory input
        ) public returns (bool r) {
        Proof memory proof;
        proof.A = Pairing.G1Point(a[0], a[1]);
        proof.B = Pairing.G2Point([b[0][1], b[0][0]], [b[1][1], b[1][0]]);
        proof.C = Pairing.G1Point(c[0], c[1]);
        uint[] memory inputValues = new uint[](input.length);
        for (uint i = 0; i < input.length; i++) {
            inputValues[i] = input[i];
        }
        if (verify(inputValues, proof) == 0) {
            emit Verified("Transaction successfully verified.");
            return true;
        } else {
            return false;
        }
    }
}
"""


def generate_solidity(vk: VerifyingKey, inputs: list[str]) -> str:
    from ..curve import R

    def s_g1(p) -> str:
        return f"{p[0]},{p[1]}"

    def s_g2(p) -> str:
        x, y = p
        return f"[{x.c1},{x.c0}],[{y.c1},{y.c0}]"

    ic_lines = "\n        ".join(
        f"vk.gammaABC[{i}] = Pairing.G1Point({s_g1(p)});"
        for i, p in enumerate(vk.ic)
    )
    out = _TEMPLATE
    out = out.replace("<%fq_modulus%>", str(Q))
    out = out.replace("<%fr_modulus%>", str(R))
    out = out.replace("<%vk_a%>", s_g1(vk.alpha_g1))
    out = out.replace("<%vk_b%>", s_g2(vk.beta_g2))
    out = out.replace("<%vk_gamma%>", s_g2(vk.gamma_g2))
    out = out.replace("<%vk_delta%>", s_g2(vk.delta_g2))
    out = out.replace("<%vk_inputs_length%>", str(len(inputs)))
    out = out.replace("<%vk_inputs%>", str(inputs))
    out = out.replace("<%vk_gammaABC_length%>", str(len(vk.ic)))
    out = out.replace("<%vk_gammaABC_pts%>", ic_lines)
    return out
