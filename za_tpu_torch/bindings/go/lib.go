// Package za2 provides Go bindings for the port's prover through its
// libza2c C ABI (the reference binding's surface, bindings/go/lib.go:
// Setup / Prove / Verify / Verbose, and Engine).
//
// Build libza2c first (za_tpu_torch/bindings/c/Makefile, into
// za_tpu_torch/_build/bindings/) and set ZA_TPU_ROOT to the checkout.
package za2

/*
#cgo LDFLAGS: -L${SRCDIR}/../../_build/bindings -lza2c
#include <stdlib.h>
#include "../c/za2c.h"
*/
import "C"

import (
	"errors"
	"unsafe"
)

const (
	errNone               = 0
	errBufferTooSmall     = 1
	errVerificationFailed = 2
)

// Verbose toggles engine logging.
func Verbose(on bool) {
	v := C.int(0)
	if on {
		v = 1
	}
	C.verbose(v)
}

// Engine chooses where Setup and Prove run: "gpu" (the default, the
// CUDA card) or "host" (the exact host code).
func Engine(name string) error {
	cName := C.CString(name)
	defer C.free(unsafe.Pointer(cName))
	if C.engine(cName) != errNone {
		return errors.New("unknown engine " + name + ": gpu or host")
	}
	return nil
}

// Setup compiles the circuit, runs the trusted setup, writes the proving
// key and returns the verifier artifact (verifierType "json"|"solidity").
func Setup(circuitPath, pkPath, verifierType string) (string, error) {
	cCircuit := C.CString(circuitPath)
	defer C.free(unsafe.Pointer(cCircuit))
	cPk := C.CString(pkPath)
	defer C.free(unsafe.Pointer(cPk))
	cVt := C.CString(verifierType)
	defer C.free(unsafe.Pointer(cVt))

	verifier := make([]byte, 1<<20)
	errBuf := make([]byte, 1<<16)
	rc := C.setup(cCircuit, cPk, cVt,
		(*C.char)(unsafe.Pointer(&verifier[0])), C.size_t(len(verifier)),
		(*C.char)(unsafe.Pointer(&errBuf[0])), C.size_t(len(errBuf)))
	switch rc {
	case errNone:
		return C.GoString((*C.char)(unsafe.Pointer(&verifier[0]))), nil
	case errBufferTooSmall:
		return "", errors.New("buffer too small")
	default:
		return "", errors.New(C.GoString((*C.char)(unsafe.Pointer(&errBuf[0]))))
	}
}

// Prove generates proof.json from a proving key and JSON inputs.
func Prove(pkPath, inputs string) (string, error) {
	cPk := C.CString(pkPath)
	defer C.free(unsafe.Pointer(cPk))
	cInputs := C.CString(inputs)
	defer C.free(unsafe.Pointer(cInputs))

	proof := make([]byte, 1<<20)
	errBuf := make([]byte, 1<<16)
	rc := C.prove(cPk, cInputs,
		(*C.char)(unsafe.Pointer(&proof[0])), C.size_t(len(proof)),
		(*C.char)(unsafe.Pointer(&errBuf[0])), C.size_t(len(errBuf)))
	switch rc {
	case errNone:
		return C.GoString((*C.char)(unsafe.Pointer(&proof[0]))), nil
	case errBufferTooSmall:
		return "", errors.New("buffer too small")
	default:
		return "", errors.New(C.GoString((*C.char)(unsafe.Pointer(&errBuf[0]))))
	}
}

// Verify checks a proof against a JSON verifying key; returns
// (false, nil) on a well-formed but invalid proof.
func Verify(verifyingKey, proofWithInputs string) (bool, error) {
	cVk := C.CString(verifyingKey)
	defer C.free(unsafe.Pointer(cVk))
	cProof := C.CString(proofWithInputs)
	defer C.free(unsafe.Pointer(cProof))

	errBuf := make([]byte, 1<<16)
	rc := C.verify(cVk, cProof,
		(*C.char)(unsafe.Pointer(&errBuf[0])), C.size_t(len(errBuf)))
	switch rc {
	case errNone:
		return true, nil
	case errVerificationFailed:
		return false, nil
	default:
		return false, errors.New(C.GoString((*C.char)(unsafe.Pointer(&errBuf[0]))))
	}
}
